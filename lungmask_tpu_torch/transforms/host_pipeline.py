"""Host (numpy/scipy) preprocessing pipeline, the strict-parity mode (a copy
of ``lungmask_tpu.transforms.host_pipeline``, which imports no jax but sits
in a package that does).

Reproduces the reference preprocessing chain bit for bit on the host
(float64 scipy resampling, the semantics of reference lungmask/utils.py:32-129)
without skimage/fill_voids: connected components come from
``lungmask_tpu_torch.ops.cc_host``. Used

* as the ``preprocessing="host"`` strict mode of the inferer, and
* by hybrid preprocessing for slices smaller than 128², which the 128-grid
  bodymask cannot take (``transforms/preprocess.py::preprocess_hybrid``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy import ndimage

from lungmask_tpu_torch.ops import cc_host

BODY_THRESHOLD_HU = -500
HU_CLIP = (-1024, 600)


def body_mask_slice(img: np.ndarray) -> np.ndarray:
    """Per-slice body mask — reference ``simple_bodymask``
    (reference lungmask/utils.py:55-82): zoom to 128², threshold at
    −500 HU, close, fill, erode ×2, keep largest 4-connected region,
    dilate ×2, zoom back."""
    orig_shape = img.shape
    small = ndimage.zoom(img, 128 / np.asarray(img.shape), order=0)
    mask = small > BODY_THRESHOLD_HU
    mask = ndimage.binary_closing(mask)
    mask = ndimage.binary_fill_holes(mask, structure=np.ones((3, 3))).astype(int)
    mask = ndimage.binary_erosion(mask, iterations=2)
    lab = cc_host.label(mask.astype(int), connectivity=1)
    nmax = int(lab.max())
    if nmax > 0:
        areas = np.bincount(lab.ravel(), minlength=nmax + 1)[1:]
        mask = lab == (int(np.argmax(areas)) + 1)
        mask = ndimage.binary_dilation(mask, iterations=2)
    return ndimage.zoom(mask, np.asarray(orig_shape) / 128, order=0)


def crop_to_body_and_resize(
    img: np.ndarray, width: int = 192, height: int = 192
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference ``crop_and_resize`` (reference lungmask/utils.py:85-111):
    bbox of the scan-order-first 8-connected bodymask region (full-image
    fallback), crop, bilinear zoom to (width, height). Integer inputs keep
    their dtype through scipy's zoom (round-half-away cast), which the device
    path replicates."""
    bmask = body_mask_slice(img)
    lab = cc_host.label(bmask)
    if lab.max() > 0:
        sl = ndimage.find_objects((lab == 1).astype(np.int8))[0]
        bbox = np.asarray([sl[0].start, sl[1].start, sl[0].stop, sl[1].stop])
    else:
        bbox = np.asarray([0, 0, bmask.shape[0], bmask.shape[1]])
    cropped = img[bbox[0] : bbox[2], bbox[1] : bbox[3]]
    out = ndimage.zoom(
        cropped, np.asarray([width, height]) / np.asarray(cropped.shape), order=1
    )
    return out, bbox


def preprocess(
    volume: np.ndarray, resolution=(256, 256)
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Reference ``preprocess`` (reference lungmask/utils.py:32-52): clip
    HU to [−1024, 600], per-slice crop-to-body + resize. Returns the slice
    stack and per-slice boxes."""
    clipped = np.clip(volume, *HU_CLIP)
    slices, boxes = [], []
    for sl in clipped:
        out, box = crop_to_body_and_resize(sl, resolution[0], resolution[1])
        slices.append(out)
        boxes.append(box)
    return np.asarray(slices), boxes


def restore_mask_geometry(
    mask: np.ndarray, box: np.ndarray, orig_size: tuple
) -> np.ndarray:
    """Reference ``reshape_mask`` (reference lungmask/utils.py:114-129):
    nearest-zoom the mask to the box size and paste into a zero canvas."""
    canvas = np.zeros(orig_size)
    box_hw = [box[2] - box[0], box[3] - box[1]]
    restored = ndimage.zoom(mask, box_hw / np.asarray(mask.shape), order=0)
    canvas[box[0] : box[2], box[1] : box[3]] = restored
    return canvas


def normalize_hu(slices: np.ndarray) -> np.ndarray:
    """HU window + scale to [0, 1] — reference mask.py:167-168: clip above 600,
    then (x + 1024) / 1624, in float64 like np.divide on int input."""
    s = np.asarray(slices, dtype=np.float64).copy()
    s[s > 600] = 600
    return (s + 1024) / 1624
