"""Pretrained-model registry (counterpart of ``lungmask_tpu.models.registry``).

The port reads the JAX package's converted-weight cache,
``~/.cache/lungmask_tpu`` (``$LUNGMASK_TPU_CACHE`` overrides), and never
downloads: a named model must already be cached there as ``.npz`` (or as the
release ``.pth``, converted on the fly), or ``modelpath`` must point at a
local ``.pth`` / ``.npz``. n_classes always comes from the weights
(lungmask/mask.py:56).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

from lungmask_tpu_torch.models import convert
from lungmask_tpu_torch.models.unet import n_classes_of

Params = Dict

# name → (release file of the torch checkpoint, registry n_classes); the
# JAX registry's table (lungmask/mask.py:22-35).
MODEL_URLS: Dict[str, Tuple[str, int]] = {
    "R231": (
        "https://github.com/JoHof/lungmask/releases/download/v0.0/unet_r231-d5d2fc3d.pth",
        3,
    ),
    "LTRCLobes": (
        "https://github.com/JoHof/lungmask/releases/download/v0.0/unet_ltrclobes-3a07043d.pth",
        6,
    ),
    "R231CovidWeb": (
        "https://github.com/JoHof/lungmask/releases/download/v0.0/unet_r231covid-0de78a7e.pth",
        3,
    ),
}


def cache_dir() -> str:
    """The JAX package's weight cache directory (``$LUNGMASK_TPU_CACHE``)."""
    return os.environ.get(
        "LUNGMASK_TPU_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "lungmask_tpu"),
    )


def get_model(
    modelname: str = "R231", modelpath: Optional[str] = None
) -> Tuple[Params, int]:
    """Resolve weights as a JAX-layout numpy tree. Returns ``(params,
    n_classes)``. ``modelpath`` (``.pth`` or ``.npz``) overrides
    ``modelname``."""
    if modelpath is not None:
        if modelpath.endswith(".npz"):
            params, _meta = convert.load_npz(modelpath)
        else:
            params, _ = convert.convert_pth(modelpath)
        return params, n_classes_of(params)
    if modelname not in MODEL_URLS:
        raise KeyError(
            f"Modelname not found. Please choose from: {list(MODEL_URLS.keys())}"
        )
    stem = os.path.splitext(os.path.basename(MODEL_URLS[modelname][0]))[0]
    npz_path = os.path.join(cache_dir(), stem + ".npz")
    pth_path = os.path.join(cache_dir(), stem + ".pth")
    if os.path.exists(npz_path):
        params, _meta = convert.load_npz(npz_path)
    elif os.path.exists(pth_path):
        params, _ = convert.convert_pth(pth_path)
    else:
        raise RuntimeError(
            f"Pretrained weights for {modelname!r} are not cached at {npz_path} "
            f"or {pth_path}, and lungmask_tpu_torch does not download. Run the "
            "JAX package once to fetch them, place the .pth there, or pass "
            "modelpath."
        )
    return params, n_classes_of(params)
