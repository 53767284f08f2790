"""``scipy.ndimage.zoom``-exact resampling (counterpart of
``lungmask_tpu.ops.resample``): the float64 host plans, their device half
(:func:`resize`, :func:`crop_resize_plan`, :func:`apply_crop_resize`, for
device preprocessing and the training labels) and the host mask paste-back.

scipy's ``zoom`` with ``grid_mode=False`` maps output index ``i`` on an axis
to input coordinate

    cc(i) = i * float64((in_size - 1) / (out_size - 1))    (0 when out_size == 1)

computed in float64, and treats ``cc > in_size - 1`` as *out of bounds*,
filling with ``cval=0``. Because the float64 division can round upward, the
LAST output sample along an axis is zeroed for some shape pairs (e.g.
128→91). The plans below replicate that arithmetic exactly.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from lungmask_tpu_torch.utils.device import resolve_device


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


def _zero_oob(x: torch.Tensor, oob: np.ndarray, axis: int) -> torch.Tensor:
    """``x`` with scipy's out-of-bounds samples along ``axis`` set to 0."""
    if not oob.any():
        return x
    shape = [1] * x.ndim
    shape[axis] = len(oob)
    mask = torch.from_numpy(oob).to(x.device).view(shape)
    return torch.where(mask, torch.zeros((), dtype=x.dtype, device=x.device), x)


def _take(x: torch.Tensor, idx: np.ndarray, axis: int) -> torch.Tensor:
    return torch.index_select(x, axis, torch.from_numpy(idx.astype(np.int64)).to(x.device))


def resize(x: torch.Tensor, out_shape: Sequence[int], order: int) -> torch.Tensor:
    """scipy-exact resize of every axis of ``x`` to ``out_shape`` on ``x``'s
    device (``resample.resize`` of the JAX package).

    Order 0 is nearest (round half up) and keeps the dtype; order 1 is
    separable linear, ``x[lo]·(1 − w) + x[hi]·w`` in float32 (an integer
    input is cast first). Out-of-bounds samples are 0, as
    ``ndimage.zoom(..., mode='constant')`` fills them.
    """
    if order not in (0, 1):
        raise ValueError("only spline orders 0 and 1 are supported")
    if len(out_shape) != x.ndim:
        raise ValueError(f"out_shape {tuple(out_shape)} does not match {x.ndim} axes")
    if order == 1 and not x.is_floating_point():
        x = x.float()
    for axis, out_size in enumerate(out_shape):
        in_size = x.shape[axis]
        if in_size == out_size:
            continue
        if order == 0:
            idx, oob = _axis_plan_np(in_size, out_size, 0)
            x = _zero_oob(_take(x, idx, axis), oob, axis)
            continue
        lo, hi, w, oob = _axis_plan_np(in_size, out_size, 1)
        shape = [1] * x.ndim
        shape[axis] = out_size
        wj = torch.from_numpy(w).to(x.device).view(shape).to(x.dtype)
        x = _zero_oob(_take(x, lo, axis) * (1 - wj) + _take(x, hi, axis) * wj, oob, axis)
    return x


_PLAN_KEYS = ("rlo", "rhi", "rw", "roob", "clo", "chi", "cw", "coob")


def crop_resize_plan(
    boxes: np.ndarray, out_shape: Tuple[int, int], order: int = 1, device=None
) -> Dict[str, torch.Tensor]:
    """Plan for a batched ``img[r0:r1, c0:c1]`` crop + scipy-exact resize
    (lungmask/utils.py:107-110), computed in float64 on the host and
    uploaded to ``device`` (CUDA unless ``"cpu"``): for each of the
    ``(N, 4)`` boxes ``(r0, c0, r1, c1)`` (half-open), the absolute source
    indices ``lo``/``hi`` (int64, for the gathers), the float32 weights
    ``w`` and the out-of-bounds flags of its rows (``r*``) and columns
    (``c*``). Order 0 gathers ``lo`` with weight 0."""
    boxes = np.asarray(boxes, dtype=np.int64)
    out_h, out_w = out_shape
    plan = {k: [] for k in _PLAN_KEYS}
    for r0, c0, r1, c1 in boxes:
        for start, size, out_size, pre in ((r0, r1 - r0, out_h, "r"), (c0, c1 - c0, out_w, "c")):
            if order == 0:
                idx, oob = _axis_plan_np(int(size), out_size, 0)
                lo = hi = idx + int(start)
                w = np.zeros(out_size, dtype=np.float32)
            else:
                lo, hi, w, oob = _axis_plan_np(int(size), out_size, 1)
                lo = lo + int(start)
                hi = hi + int(start)
            plan[pre + "lo"].append(lo.astype(np.int64))
            plan[pre + "hi"].append(hi.astype(np.int64))
            plan[pre + "w"].append(w)
            plan[pre + "oob"].append(oob)
    empty = {"lo": np.int64, "hi": np.int64, "w": np.float32, "oob": bool}
    device = resolve_device(device)
    return {
        k: torch.from_numpy(
            np.stack(v) if v else np.zeros((0, out_h if k[0] == "r" else out_w), empty[k[1:]])
        ).to(device)
        for k, v in plan.items()
    }


def apply_crop_resize(imgs: torch.Tensor, plan: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Apply a :func:`crop_resize_plan` to an ``(N, H, W)`` batch on its
    device: float32 (an integer batch is cast first), rows first
    (``img[lo]·(1 − w) + img[hi]·w``), then columns; out-of-bounds samples
    are 0."""
    imgf = imgs if imgs.is_floating_point() else imgs.float()
    n, out_h = plan["rlo"].shape
    out_w = plan["clo"].shape[1]
    b = torch.arange(n, device=imgf.device).view(n, 1)
    rw = plan["rw"].to(imgf.dtype).unsqueeze(2)
    top = imgf[b, plan["rlo"]] * (1 - rw) + imgf[b, plan["rhi"]] * rw  # (N, out_h, W)
    cw = plan["cw"].to(imgf.dtype).unsqueeze(1)

    def cols(idx):
        return torch.gather(top, 2, idx.unsqueeze(1).expand(n, out_h, out_w))

    out = cols(plan["clo"]) * (1 - cw) + cols(plan["chi"]) * cw
    oob = plan["roob"].unsqueeze(2) | plan["coob"].unsqueeze(1)
    return torch.where(oob, torch.zeros((), dtype=out.dtype, device=out.device), out)


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
