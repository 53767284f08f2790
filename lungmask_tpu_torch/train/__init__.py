"""Fine-tuning the U-Net on the GPU (counterpart of ``lungmask_tpu.train``):
losses, the train step, ``default_optimizer`` (``train/optim.py``, in place
of optax), ``fit`` and exact-resume checkpoints; ``python -m
lungmask_tpu_torch.train.finetune`` drives it from a directory of pairs."""

from lungmask_tpu_torch.train.augment import Augmenter
from lungmask_tpu_torch.train.loop import FitResult, default_optimizer, evaluate, fit
from lungmask_tpu_torch.train.trainer import (
    TrainState,
    cross_entropy_loss,
    dice_loss,
    init_train_state,
    make_train_step,
)

__all__ = [
    "Augmenter",
    "FitResult",
    "TrainState",
    "cross_entropy_loss",
    "default_optimizer",
    "dice_loss",
    "evaluate",
    "fit",
    "init_train_state",
    "make_train_step",
]
