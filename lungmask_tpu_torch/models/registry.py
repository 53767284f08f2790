"""Pretrained-model registry and weight store (counterpart of
``lungmask_tpu.models.registry``).

Three named models (R231, LTRCLobes, R231CovidWeb) resolved from release
URLs with a local cache, and a local-path override in which the
checkpoint's own class count wins over the registry (lungmask/mask.py:22-68).

* A named model's release ``.pth`` is fetched into the cache once
  (``.part`` then rename, a 15 s timeout), its full sha256 checked against
  the 8-hex prefix in the release file name, whether it was fetched or
  placed there by hand, then converted once and cached as ``.npz`` (folded
  BatchNorm, HWIO kernels) with ``meta={"source", "model",
  "source_sha256"}``. A cached ``.npz`` whose recorded source sha256
  disagrees with the registry is refused.
* The cache is the JAX package's, ``~/.cache/lungmask_tpu``
  (``$LUNGMASK_TPU_CACHE`` overrides), under the same file names, so each
  package reads what the other wrote.
"""

from __future__ import annotations

import hashlib
import json
import os
import urllib.request
from typing import Dict, Optional, Tuple

import numpy as np

from lungmask_tpu_torch.logger import logger
from lungmask_tpu_torch.models import convert
from lungmask_tpu_torch.models.unet import n_classes_of

Params = Dict

# name → (release URL of the torch checkpoint, registry n_classes); the
# reference's table (lungmask/mask.py:22-35). The n_classes entry is
# advisory: the loaded checkpoint's final bias length is authoritative
# (mask.py:56).
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
    """Weight cache directory, created if missing ($LUNGMASK_TPU_CACHE
    overrides)."""
    d = os.environ.get(
        "LUNGMASK_TPU_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "lungmask_tpu"),
    )
    os.makedirs(d, exist_ok=True)
    return d


def _sha256_prefix_of_name(filename: str) -> Optional[str]:
    """torch.hub convention: ``name-<shaprefix>.pth``."""
    stem = os.path.splitext(filename)[0]
    if "-" in stem:
        return stem.rsplit("-", 1)[1]
    return None


def _sha256_full(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _verify_sha(path: str, expected_prefix: Optional[str]) -> str:
    """Full-file sha256, checked against the registry prefix when given.
    Returns the digest so callers reuse it (one pass over the checkpoint)."""
    digest = _sha256_full(path)
    if expected_prefix and not digest.startswith(expected_prefix):
        raise RuntimeError(
            f"Checksum mismatch for {path}: sha256={digest}, expected prefix {expected_prefix}"
        )
    return digest


def _download(url: str, dest: str) -> None:
    logger.info(f"Downloading {url} -> {dest}")
    tmp = dest + ".part"
    # Bounded timeout: where egress is blocked, the DNS/connect stall would
    # otherwise hold the caller for minutes.
    with urllib.request.urlopen(url, timeout=15) as r, open(tmp, "wb") as f:
        while True:
            chunk = r.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    os.replace(tmp, dest)


def _npz_cache_path(modelname: str) -> str:
    url, _ = MODEL_URLS[modelname]
    stem = os.path.splitext(os.path.basename(url))[0]
    return os.path.join(cache_dir(), stem + ".npz")


def _plan_of(meta) -> Dict:
    """The plan in a 3-D model's meta (``models/unet3d.py``), or {} where
    the meta names another architecture (the 2-D U-Net's name none)."""
    if not isinstance(meta, dict) or meta.get("architecture") != "nnunet3d":
        return {}
    return dict(meta["plan"])


def model_plan(modelpath: str) -> Dict:
    """The plan of a 3-D model's ``.npz``, read without its arrays, or {}
    for any other checkpoint."""
    if not modelpath.endswith(".npz"):
        return {}
    with np.load(modelpath) as data:
        if "__meta__" not in data.files:
            return {}
        return _plan_of(json.loads(bytes(data["__meta__"]).decode("utf-8")))


def get_model(
    modelname: str = "R231", modelpath: Optional[str] = None
) -> Tuple[Params, int]:
    """Resolve weights as a JAX-layout numpy tree. Returns ``(params,
    n_classes)``. ``modelpath`` (``.pth`` or converted ``.npz``) overrides
    ``modelname``, and n_classes always comes from the weights; a 3-D
    model's ``.npz`` (:func:`model_plan`) gives its flat tree in torch's
    layouts and its plan's class count."""
    if modelpath is not None:
        if modelpath.endswith(".npz"):
            params, meta = convert.load_npz(modelpath)
            plan = _plan_of(meta)
            if plan:  # a 3-D model: its flat tree, by its own keys
                return convert.flatten_params(params), int(plan["n_classes"])
        else:
            params, _ = convert.convert_pth(modelpath)
        return params, n_classes_of(params)

    if modelname not in MODEL_URLS:
        raise KeyError(
            f"Modelname not found. Please choose from: {list(MODEL_URLS.keys())}"
        )

    npz_path = _npz_cache_path(modelname)
    url, _ = MODEL_URLS[modelname]
    expected_sha = _sha256_prefix_of_name(os.path.basename(url))
    if not os.path.exists(npz_path):
        pth_path = os.path.join(cache_dir(), os.path.basename(url))
        if not os.path.exists(pth_path):
            try:
                _download(url, pth_path)
            except Exception as e:  # no egress, a missing file, a refused connection
                raise RuntimeError(
                    f"Pretrained weights for {modelname!r} are not cached at "
                    f"{pth_path} and could not be downloaded ({e}). Place the "
                    f".pth there, point modelpath at a local checkpoint, or set "
                    f"$LUNGMASK_TPU_CACHE to a directory containing it."
                ) from e
        # Verify whether freshly fetched or placed in the cache by hand: a
        # truncated manual copy must not be converted silently.
        source_sha = _verify_sha(pth_path, expected_sha)
        params, _ = convert.convert_pth(pth_path)
        convert.save_npz(
            npz_path,
            params,
            meta={
                "source": os.path.basename(url),
                "model": modelname,
                "source_sha256": source_sha,
            },
        )
        logger.info(f"Converted {pth_path} -> {npz_path}")
    else:
        params, meta = convert.load_npz(npz_path)
        recorded = str(meta.get("source_sha256", ""))
        if expected_sha and recorded and not recorded.startswith(expected_sha):
            raise RuntimeError(
                f"Converted-weight cache {npz_path} records source "
                f"sha256={recorded}, which does not match the registry's "
                f"expected prefix {expected_sha}. Delete the cache entry and "
                "re-convert."
            )
    return params, n_classes_of(params)
