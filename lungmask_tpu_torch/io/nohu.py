"""noHU input mode: 8-bit image stacks (jpg/png) mapped to pseudo-HU.

Reconstructed capability: the reference documented a ``--noHU`` path for
non-HU 8-bit inputs in versions 0.2.5–0.2.14 and removed the code but kept the
docs (the reference README.md:111-113; SURVEY §2.1 note). BASELINE.json
config 2 requires it, so it is rebuilt here: 8-bit intensities are linearly
mapped onto the model's HU intensity window [−1024, 600] (the window the net
was trained on, lungmask/mask.py:167-168), i.e.

    pseudo_hu = round(x / 255 * 1624) - 1024

Slices are stacked in filename order. The output of inference in this mode is
per-slice masks in the input pixel grid.
"""

from __future__ import annotations

import os
import re
from typing import List, Sequence

import numpy as np

from lungmask_tpu_torch.io.image import MedicalImage

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def to_pseudo_hu(stack: np.ndarray) -> np.ndarray:
    """(N, H, W) uint8/float [0, 255] → int16 pseudo-HU in [−1024, 600]."""
    x = np.asarray(stack, dtype=np.float64)
    return (np.round(x / 255.0 * 1624.0) - 1024.0).astype(np.int16)


def _read_gray_frames(path: str) -> List[np.ndarray]:
    """All grayscale frames of an image file — multi-page TIFF stacks yield
    every page (a single-file '8-bit image stack' per the --noHU contract)."""
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return [np.asarray(fr.convert("L")) for fr in ImageSequence.Iterator(im)]


def _natural_key(name: str):
    """slice2 < slice10: numeric runs compare as integers, not strings."""
    return [
        int(tok) if tok.isdigit() else tok.lower()
        for tok in re.split(r"(\d+)", name)
    ]


def load_image_stack(paths: Sequence[str]) -> MedicalImage:
    """Load a list of 8-bit image files (each possibly multi-frame) as a
    pseudo-HU volume."""
    slices = [fr for p in paths for fr in _read_gray_frames(p)]
    shapes = {s.shape for s in slices}
    if len(shapes) != 1:
        raise ValueError(f"inconsistent slice shapes: {sorted(shapes)}")
    return MedicalImage(to_pseudo_hu(np.stack(slices)))


def load_image_directory(path: str) -> MedicalImage:
    """Load all images under ``path`` (natural filename order, so
    ``slice2 < slice10``) as a pseudo-HU volume."""
    files = [
        os.path.join(path, f)
        for f in sorted(os.listdir(path), key=_natural_key)
        if f.lower().endswith(IMAGE_EXTS)
    ]
    if not files:
        raise ValueError(f"no image files found in {path}")
    return load_image_stack(files)
