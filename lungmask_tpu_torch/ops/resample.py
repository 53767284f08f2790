"""Host-side ``scipy.ndimage.zoom``-exact resampling plans and the mask
paste-back (the numpy half of ``lungmask_tpu.ops.resample``).

scipy's ``zoom`` with ``grid_mode=False`` maps output index ``i`` on an axis
to input coordinate

    cc(i) = i * float64((in_size - 1) / (out_size - 1))    (0 when out_size == 1)

computed in float64, and treats ``cc > in_size - 1`` as *out of bounds*,
filling with ``cval=0``. Because the float64 division can round upward, the
LAST output sample along an axis is zeroed for some shape pairs (e.g.
128→91). The plans below replicate that arithmetic exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _axis_coords_np(in_size: int, out_size: int) -> np.ndarray:
    if out_size == 1:
        return np.zeros(1, dtype=np.float64)
    zoom = np.float64(in_size - 1) / np.float64(out_size - 1)
    return np.arange(out_size, dtype=np.float64) * zoom


def _axis_plan_np(in_size: int, out_size: int, order: int):
    """Exact per-axis gather plan.

    Returns ``(idx, oob)`` for order 0 and ``(lo, hi, w, oob)`` for order 1,
    as numpy arrays. ``oob`` marks samples scipy fills with cval=0.
    """
    cc = _axis_coords_np(in_size, out_size)
    oob = (cc > in_size - 1) | (cc < 0)
    if order == 0:
        idx = np.clip(np.floor(cc + 0.5).astype(np.int32), 0, in_size - 1)
        return idx, oob
    lo = np.floor(cc).astype(np.int32)
    w = (cc - lo).astype(np.float32)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    return lo, hi, w, oob


def paste_masks_host(
    masks: np.ndarray, boxes: np.ndarray, canvas_shape: Tuple[int, int]
) -> np.ndarray:
    """Batched reshape_mask (lungmask/utils.py:114-129): nearest-zoom each
    (mh, mw) mask to its box and paste it into a zero (H, W) canvas. uint8
    stacks go to the native core (lm_paste_masks, one pass); the numpy loop
    :func:`paste_masks_numpy` is the oracle and the fallback."""
    masks = np.asarray(masks)
    if masks.dtype == np.uint8 and masks.ndim == 3:
        from lungmask_tpu_torch.ops import native

        out = native.paste_masks(masks, boxes, canvas_shape)
        if out is not None:
            return out
    return paste_masks_numpy(masks, boxes, canvas_shape)


def paste_masks_numpy(
    masks: np.ndarray, boxes: np.ndarray, canvas_shape: Tuple[int, int]
) -> np.ndarray:
    """The numpy reference implementation of :func:`paste_masks_host`."""
    masks = np.asarray(masks)
    boxes = np.asarray(boxes, dtype=np.int64)
    n, mh, mw = masks.shape
    h, w = canvas_shape
    out = np.zeros((n, h, w), dtype=masks.dtype)
    for i, (r0, c0, r1, c1) in enumerate(boxes):
        bh, bw = int(r1 - r0), int(c1 - c0)
        if bh <= 0 or bw <= 0:
            continue
        ridx, roob = _axis_plan_np(mh, bh, 0)
        cidx, coob = _axis_plan_np(mw, bw, 0)
        block = masks[i][np.ix_(ridx, cidx)]
        if roob.any() or coob.any():
            block = block.copy()
            block[roob, :] = 0
            block[:, coob] = 0
        out[i, r0:r1, c0:c1] = block
    return out
