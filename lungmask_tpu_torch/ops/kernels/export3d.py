"""Kernel (b): the export of a 3-D model's logits to the input grid, fused:
trilinear resample + argmax + paste into the uncropped volume + 4-bit pack
(Triton, for nnU-Net's 3-D U-Net, ``runtime/sliding_window.py``).

It replaces no TPU kernel: the JAX package has no 3-D network. It was added
so that the logits at the input grid (six classes × 192×512² float32, 1.21
GB) are never written: nnU-Net resamples the logits to the cropped input
shape at order 1 (``skimage.transform.resize``, mode "edge", i.e.
``scipy.ndimage.zoom(order=1, mode="nearest", grid_mode=True)``), takes
the argmax and pastes it into the uncropped shape with 0 outside the box;
here each output voxel is computed where it is stored.

Per output voxel ``(z, y, x)`` inside the box ``[z0, z0 + Dc) × …``, along
each axis the source coordinate ``c = (i + 0.5)·(n_in / n_out) − 0.5``
(``i`` the voxel's index in the box), clamped at 0, its lower neighbour
``min(floor(c), n_in − 1)``, the upper one clamped at ``n_in − 1``, and
the weight ``c − floor(c)``; the eight corners are blended along x, then y,
then z, per class, in float32; the first class of the largest value wins.
Voxels outside the box are 0. With ≤ 16 classes and an even width, voxel
``2j`` goes to the low nibble of byte ``j`` and ``2j + 1`` to the high one
(``ops/packing.pack_bits``' order); else one byte a voxel.

What bounds it on the H100: bytes. It must read the logits once (K·d·h·w
float32, 263 MB at 192×239²) and write the packed mask (D·H·W/2, 25 MB);
the arithmetic, 48 fused multiply-adds a voxel and class pair, is a sixth
of that time at the float32 rate. Each program takes one output row and
``BX`` bytes of it; the corners it reads lie on two source rows in each of
two source planes, which neighbouring programs share, so most reads hit
the L2.

:func:`export_packed` takes the plain version (:func:`export_reference`)
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
Triton is imported, and the kernel compiled, at the first CUDA call.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from lungmask_tpu_torch.ops.kernels import count_launch

BX = 128  # output bytes a program
_KERNEL = None


def packing(n_classes: int, width: int) -> int:
    """Voxels a byte: 2 (4-bit classes) where ≤ 16 classes and the width is
    even, else 1."""
    return 2 if n_classes <= 16 and width % 2 == 0 else 1


def _axis(n_in: int, n_out: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lo, hi, w) of each output index along one axis, in the kernel's
    float32 arithmetic."""
    scale = torch.tensor(n_in / n_out, dtype=torch.float32)
    c = (torch.arange(n_out, dtype=torch.float32) + 0.5) * scale - 0.5
    c = torch.clamp(c, min=0.0)
    fl = torch.floor(c)
    lo = torch.clamp(fl.long(), max=n_in - 1)
    hi = torch.clamp(lo + 1, max=n_in - 1)
    return lo.to(device), hi.to(device), (c - fl).to(device)


def export_reference(logits: torch.Tensor, box: Sequence[int], full_shape: Sequence[int]
                     ) -> torch.Tensor:
    """Plain torch: ``(K, d, h, w)`` float32 logits, the crop box ``(z0,
    z1, y0, y1, x0, x1)`` and the uncropped ``(D, H, W)`` → the packed
    uint8 mask ``(D, H, W / per)`` (:func:`packing`), as the kernel
    computes it."""
    k, d, h, w = logits.shape
    z0, z1, y0, y1, x0, x1 = (int(b) for b in box)
    dev = logits.device
    lx, hx, wx = _axis(w, x1 - x0, dev)
    ly, hy, wy = _axis(h, y1 - y0, dev)
    lz, hz, wz = _axis(d, z1 - z0, dev)
    lg = logits.float()
    t = lg[..., lx] * (1 - wx) + lg[..., hx] * wx  # (K, d, h, Wc)
    t = t[:, :, ly] * (1 - wy)[:, None] + t[:, :, hy] * wy[:, None]  # (K, d, Hc, Wc)
    t = t[:, lz] * (1 - wz)[:, None, None] + t[:, hz] * wz[:, None, None]  # (K, Dc, Hc, Wc)
    cls = torch.argmax(t, dim=0).to(torch.uint8)
    full = torch.zeros(tuple(int(s) for s in full_shape), dtype=torch.uint8, device=dev)
    full[z0:z1, y0:y1, x0:x1] = cls
    if packing(k, full.shape[2]) == 1:
        return full
    return full[..., 0::2] | (full[..., 1::2] << 4)


def _build():
    global _KERNEL, tl
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl  # a module global: Triton reads a kernel's names from there

    @triton.jit
    def lm_export3d(lg_ptr, out_ptr, d, h, w, z0, y0, x0, dc, hc, wc, H, W, WB,
                    sz, sy, sx, K: tl.constexpr, PER: tl.constexpr, BX: tl.constexpr):
        row = tl.program_id(0)
        z = row // H
        y = row % H
        j = tl.program_id(1) * BX + tl.arange(0, BX)
        jmask = j < WB
        # z and y: one source coordinate a program
        cz = tl.maximum(((z - z0).to(tl.float32) + 0.5) * sz - 0.5, 0.0)
        fz = tl.floor(cz)
        z_lo = tl.minimum(fz.to(tl.int32), d - 1)
        z_hi = tl.minimum(z_lo + 1, d - 1)
        az = cz - fz
        cy = tl.maximum(((y - y0).to(tl.float32) + 0.5) * sy - 0.5, 0.0)
        fy = tl.floor(cy)
        y_lo = tl.minimum(fy.to(tl.int32), h - 1)
        y_hi = tl.minimum(y_lo + 1, h - 1)
        ay = cy - fy
        row_in = (z >= z0) & (z < z0 + dc) & (y >= y0) & (y < y0 + hc)
        plane = h * w
        r00 = z_lo * plane + y_lo * w
        r01 = z_lo * plane + y_hi * w
        r10 = z_hi * plane + y_lo * w
        r11 = z_hi * plane + y_hi * w
        packed = tl.zeros([BX], dtype=tl.int32)
        for q in tl.static_range(PER):
            x = j * PER + q
            cx = tl.maximum(((x - x0).to(tl.float32) + 0.5) * sx - 0.5, 0.0)
            fx = tl.floor(cx)
            x_lo = tl.minimum(fx.to(tl.int32), w - 1)
            x_hi = tl.minimum(x_lo + 1, w - 1)
            ax = cx - fx
            best = tl.full([BX], float("-inf"), tl.float32)
            cls = tl.zeros([BX], dtype=tl.int32)
            for k in tl.static_range(K):
                base = lg_ptr + k * d * plane
                a00 = tl.load(base + r00 + x_lo, mask=jmask, other=0.0)
                b00 = tl.load(base + r00 + x_hi, mask=jmask, other=0.0)
                a01 = tl.load(base + r01 + x_lo, mask=jmask, other=0.0)
                b01 = tl.load(base + r01 + x_hi, mask=jmask, other=0.0)
                a10 = tl.load(base + r10 + x_lo, mask=jmask, other=0.0)
                b10 = tl.load(base + r10 + x_hi, mask=jmask, other=0.0)
                a11 = tl.load(base + r11 + x_lo, mask=jmask, other=0.0)
                b11 = tl.load(base + r11 + x_hi, mask=jmask, other=0.0)
                v00 = a00 * (1 - ax) + b00 * ax
                v01 = a01 * (1 - ax) + b01 * ax
                v10 = a10 * (1 - ax) + b10 * ax
                v11 = a11 * (1 - ax) + b11 * ax
                v0 = v00 * (1 - ay) + v01 * ay
                v1 = v10 * (1 - ay) + v11 * ay
                v = v0 * (1 - az) + v1 * az
                better = v > best
                best = tl.where(better, v, best)
                cls = tl.where(better, k, cls)
            inside = row_in & (x >= x0) & (x < x0 + wc)
            cls = tl.where(inside, cls, 0)
            packed = packed | (cls << (4 * q))
        tl.store(out_ptr + row.to(tl.int64) * WB + j, packed.to(tl.uint8), mask=jmask)

    _KERNEL = lm_export3d
    return _KERNEL


def export_packed(logits: torch.Tensor, box: Sequence[int], full_shape: Sequence[int]
                  ) -> torch.Tensor:
    """``(K, d, h, w)`` float32 logits at the model's grid (those of the
    cropped volume), the crop box ``(z0, z1, y0, y1, x0, x1)`` in the
    uncropped ``(D, H, W)`` → the packed uint8 class mask ``(D, H, W /
    per)`` (:func:`packing`). A CPU tensor goes to
    :func:`export_reference`; a CUDA tensor to the kernel, whose launches
    are counted in ``export_packed.launches``."""
    if logits.ndim != 4:
        raise ValueError(f"expected (K, d, h, w) logits, got {tuple(logits.shape)}")
    if logits.device.type == "cpu":
        return export_reference(logits, box, full_shape)
    if logits.device.type != "cuda":
        raise ValueError(f"export_packed has no kernel for device {logits.device}")
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError("export_packed takes contiguous float32 logits")
    k, d, h, w = (int(s) for s in logits.shape)
    z0, z1, y0, y1, x0, x1 = (int(b) for b in box)
    big_d, big_h, big_w = (int(s) for s in full_shape)
    if not (0 <= z0 < z1 <= big_d and 0 <= y0 < y1 <= big_h and 0 <= x0 < x1 <= big_w):
        raise ValueError(f"box {tuple(box)} does not lie in {tuple(full_shape)}")
    if k * d * h * w >= 2**31:
        raise ValueError("export_packed indexes the logits with 32-bit offsets")
    per = packing(k, big_w)
    wb = big_w // per
    out = torch.empty((big_d, big_h, wb), dtype=torch.uint8, device=logits.device)
    kernel = _build()
    f32 = lambda a, b: float(np.float32(a / b))  # noqa: E731  (the float32 scale of export_reference)
    with torch.cuda.device(logits.device):
        kernel[(big_d * big_h, -(-wb // BX))](
            logits, out, d, h, w, z0, y0, x0, z1 - z0, y1 - y0, x1 - x0, big_h, big_w, wb,
            f32(d, z1 - z0), f32(h, y1 - y0), f32(w, x1 - x0), K=k, PER=per, BX=BX,
            num_warps=4)
    count_launch(export_packed)
    return out


export_packed.launches = 0


def bytes_moved(n_classes: int, logit_shape: Sequence[int], full_shape: Sequence[int]) -> int:
    """The bytes the export must move: the float32 logits read once and the
    packed mask written once (the bound of :func:`export_packed`)."""
    d, h, w = (int(s) for s in full_shape)
    return 4 * n_classes * int(np.prod(logit_shape)) + d * h * (w // packing(n_classes, w))
