from lungmask_tpu_torch.models.registry import MODEL_URLS, get_model
from lungmask_tpu_torch.models.unet import (
    init_params,
    n_classes_of,
    unet_argmax,
    unet_logits,
)

__all__ = [
    "MODEL_URLS",
    "get_model",
    "init_params",
    "n_classes_of",
    "unet_argmax",
    "unet_logits",
]
