"""Drop-in compatibility layer: the reference's module-level names (the port
of ``lungmask_tpu.compat``).

Users migrating from JoHof/lungmask can keep their imports:

    from lungmask_tpu_torch.compat import (
        LMInferer, apply, apply_fused,            # lungmask.mask
        MODEL_URLS,
        preprocess, postprocessing, reshape_mask,  # lungmask.utils
        simple_bodymask, crop_and_resize, bbox_3D,
        keep_largest_connected_component,
        read_dicoms, load_input_image, get_DICOM_tags_to_keep,
    )

Each name matches the reference's signature and observable behavior
(lungmask/mask.py, lungmask/utils.py); the
implementations are the port's own (the host strict pipeline and the native
host core where the reference ran per-slice CPU loops).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from lungmask_tpu_torch.inferer import LMInferer, apply, apply_fused
from lungmask_tpu_torch.io.loader import (
    DICOM_METADATA_TO_KEEP,
    get_DICOM_tags_to_keep,
    load_input_image,
    read_dicoms,
)
from lungmask_tpu_torch.models.registry import MODEL_URLS
from lungmask_tpu_torch.ops import cc_host
from lungmask_tpu_torch.transforms import host_pipeline
from lungmask_tpu_torch.transforms.postprocess import postprocessing


def get_model(modelname: str = "R231", modelpath=None, device=None):
    """Reference ``mask.get_model`` (mask.py:38-68) — returns a ready-to-run
    model object (a ``runtime.engine.UNetRunner``; call ``.run_numpy(slices)``
    or pass it to the deprecated ``apply(model=...)``). ``device`` is
    resolved as ``LMInferer``'s: None means the CUDA device, which must
    exist; pass ``"cpu"`` to run on the CPU."""
    from lungmask_tpu_torch.models.registry import get_model as _get
    from lungmask_tpu_torch.runtime.engine import UNetRunner
    from lungmask_tpu_torch.utils.device import resolve_device

    params, n_classes = _get(modelname, modelpath)
    return UNetRunner(params, n_classes, device=resolve_device(device))


def preprocess(img: np.ndarray, resolution=[192, 192]) -> Tuple[np.ndarray, list]:
    """Reference ``utils.preprocess`` (utils.py:32-52)."""
    return host_pipeline.preprocess(img, resolution=tuple(resolution))


def simple_bodymask(img: np.ndarray) -> np.ndarray:
    """Reference ``utils.simple_bodymask`` (utils.py:55-82)."""
    return host_pipeline.body_mask_slice(img)


def crop_and_resize(img: np.ndarray, width: int = 192, height: int = 192):
    """Reference ``utils.crop_and_resize`` (utils.py:85-111)."""
    return host_pipeline.crop_to_body_and_resize(img, width=width, height=height)


def reshape_mask(mask: np.ndarray, tbox, origsize: tuple) -> np.ndarray:
    """Reference ``utils.reshape_mask`` (utils.py:114-129)."""
    return host_pipeline.restore_mask_geometry(mask, tbox, origsize)


def bbox_3D(labelmap: np.ndarray, margin: int = 2) -> np.ndarray:
    """Reference ``utils.bbox_3D`` (utils.py:361-387)."""
    return cc_host.bbox_nd(labelmap, margin=margin)


def keep_largest_connected_component(mask: np.ndarray) -> np.ndarray:
    """Reference ``utils.keep_largest_connected_component`` (utils.py:390-404)."""
    return cc_host.keep_largest_connected_component(mask)


__all__ = [
    "LMInferer",
    "apply",
    "apply_fused",
    "get_model",
    "MODEL_URLS",
    "DICOM_METADATA_TO_KEEP",
    "get_DICOM_tags_to_keep",
    "load_input_image",
    "read_dicoms",
    "preprocess",
    "postprocessing",
    "simple_bodymask",
    "crop_and_resize",
    "reshape_mask",
    "bbox_3D",
    "keep_largest_connected_component",
]
