"""Kernel (a): InstanceNorm3d + LeakyReLU, fused, over a conv's output
(Triton, for nnU-Net's 3-D U-Net, ``models/unet3d.py``).

It replaces no TPU kernel: the JAX package has no 3-D network. It was
added because each of the U-Net's 22 normalisations reads and writes a
whole activation (at the first stage 134 MB a 128³ patch in bf16, 805 MB
with the plan's six patches a forward), and torch's ``instance_norm``
followed by ``leaky_relu`` runs over it four times or more, with float32
copies.

What bounds it on the H100: bytes. Per element it must read 2 bytes (bf16)
and write 2; the statistics are a few KB. The design reads the input twice
and writes it once, in three launches:

1. ``lm_norm3d_stats``: each program sums a slab of rows (voxels) of the
   ``(N, V, C)`` view of the ``channels_last_3d`` tensor, ``BC`` channels
   wide, shifted by the slab's first row (so the float32 sums of squares do
   not cancel), and writes the slab's mean and sum of squared deviations;
2. ``lm_norm3d_merge``: per sample and channel block, the slabs' partials
   merged (the mean as the slabs' means weighted by their rows, then the
   sum of squared deviations as each slab's own plus its rows times its
   mean's squared distance from the mean: Chan et al.'s update, summed in a
   fixed order), the biased variance, and the affine folded into one scale
   and shift;
3. ``lm_norm3d_apply``: ``y = x·scale + shift``, LeakyReLU, stored in the
   output's type (in place where ``out is x``).

No atomics: the result does not depend on the order in which programs
run. The second read of the input comes mostly from the 50 MB L2 at the
deep stages and from HBM at the first ones.

:func:`instance_norm_leaky` takes the plain version
(:func:`instance_norm_leaky_reference`) only for a tensor on the CPU; for a
CUDA tensor it launches the kernels or raises. Triton is imported, and the
kernels compiled, at the first CUDA call.
"""

from __future__ import annotations

from typing import Optional

import torch

from lungmask_tpu_torch.ops.kernels import count_launch

TARGET_PROGRAMS = 1024  # slabs a call aims for, so that the 132 SMs fill
_KERNELS = None


def instance_norm_leaky_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                                  eps: float, slope: float,
                                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch: per sample and channel the float32 mean and biased
    variance over D·H·W, ``(x − mean)/sqrt(var + eps)·weight + bias``,
    LeakyReLU with ``slope``, in ``x``'s type."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(2, 3, 4), unbiased=False, keepdim=True)
    scale = weight.float().view(1, -1, 1, 1, 1) * torch.rsqrt(var + eps)
    y = (xf - mean) * scale + bias.float().view(1, -1, 1, 1, 1)
    y = torch.where(y >= 0, y, y * slope).to(x.dtype)
    if out is None:
        return y
    out.copy_(y)
    return out


def _build():
    """Compile the three Triton kernels (once)."""
    global _KERNELS, tl
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language as tl  # a module global: Triton reads a kernel's names from there

    @triton.jit
    def lm_norm3d_stats(x_ptr, part_ptr, V, C, rows, nblk,
                        BV: tl.constexpr, BC: tl.constexpr):
        pid = tl.program_id(0)
        cb = tl.program_id(1)
        n = pid // nblk
        b = pid % nblk
        cols = cb * BC + tl.arange(0, BC)
        cmask = cols < C
        row0 = b * rows
        row_end = tl.minimum(row0 + rows, V)
        base = x_ptr + n.to(tl.int64) * V * C
        shift = tl.load(base + row0.to(tl.int64) * C + cols, mask=cmask, other=0.0).to(tl.float32)
        acc1 = tl.zeros([BV, BC], dtype=tl.float32)
        acc2 = tl.zeros([BV, BC], dtype=tl.float32)
        for r in range(row0, row_end, BV):
            rr = r + tl.arange(0, BV)
            m = (rr[:, None] < row_end) & cmask[None, :]
            v = tl.load(base + rr[:, None].to(tl.int64) * C + cols[None, :], mask=m, other=0.0)
            d = tl.where(m, v.to(tl.float32) - shift[None, :], 0.0)
            acc1 += d
            acc2 += d * d
        s1 = tl.sum(acc1, axis=0)
        s2 = tl.sum(acc2, axis=0)
        cnt = (row_end - row0).to(tl.float32)
        out = part_ptr + (n.to(tl.int64) * nblk + b) * 2 * C
        tl.store(out + cols, shift + s1 / cnt, mask=cmask)
        tl.store(out + C + cols, s2 - s1 * s1 / cnt, mask=cmask)

    @triton.jit
    def lm_norm3d_merge(part_ptr, w_ptr, b_ptr, ss_ptr, V, C, rows, nblk, eps,
                        BB: tl.constexpr, BC: tl.constexpr):
        n = tl.program_id(0)
        cb = tl.program_id(1)
        cols = cb * BC + tl.arange(0, BC)
        cmask = cols < C
        base = part_ptr + n.to(tl.int64) * nblk * 2 * C
        total = tl.zeros([BC], dtype=tl.float32)
        for b0 in range(0, nblk, BB):
            bb = b0 + tl.arange(0, BB)
            m = (bb[:, None] < nblk) & cmask[None, :]
            nb = tl.minimum(rows, V - bb * rows).to(tl.float32)
            mb = tl.load(base + bb[:, None] * 2 * C + cols[None, :], mask=m, other=0.0)
            total += tl.sum(tl.where(m, mb * nb[:, None], 0.0), axis=0)
        mean = total / V
        m2 = tl.zeros([BC], dtype=tl.float32)
        for b0 in range(0, nblk, BB):
            bb = b0 + tl.arange(0, BB)
            m = (bb[:, None] < nblk) & cmask[None, :]
            nb = tl.minimum(rows, V - bb * rows).to(tl.float32)
            mb = tl.load(base + bb[:, None] * 2 * C + cols[None, :], mask=m, other=0.0)
            m2b = tl.load(base + bb[:, None] * 2 * C + C + cols[None, :], mask=m, other=0.0)
            d = mb - mean[None, :]
            m2 += tl.sum(tl.where(m, m2b + nb[:, None] * d * d, 0.0), axis=0)
        var = tl.maximum(m2 / V, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        scale = tl.load(w_ptr + cols, mask=cmask, other=1.0) * rstd
        shift = tl.load(b_ptr + cols, mask=cmask, other=0.0) - mean * scale
        out = ss_ptr + n.to(tl.int64) * 2 * C
        tl.store(out + cols, scale, mask=cmask)
        tl.store(out + C + cols, shift, mask=cmask)

    @triton.jit
    def lm_norm3d_apply(x_ptr, y_ptr, ss_ptr, V, C, slope,
                        BV: tl.constexpr, BC: tl.constexpr):
        pv = tl.program_id(0)
        n = tl.program_id(1)
        cb = tl.program_id(2)
        cols = cb * BC + tl.arange(0, BC)
        cmask = cols < C
        rr = pv * BV + tl.arange(0, BV)
        m = (rr[:, None] < V) & cmask[None, :]
        scale = tl.load(ss_ptr + n * 2 * C + cols, mask=cmask, other=0.0)
        shift = tl.load(ss_ptr + n * 2 * C + C + cols, mask=cmask, other=0.0)
        off = n.to(tl.int64) * V * C + rr[:, None].to(tl.int64) * C + cols[None, :]
        v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        y = v * scale[None, :] + shift[None, :]
        y = tl.where(y >= 0, y, y * slope)
        tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=m)

    _KERNELS = (lm_norm3d_stats, lm_norm3d_merge, lm_norm3d_apply)
    return _KERNELS


def launch_plan(n: int, v: int, c: int) -> dict:
    """Tile and slab sizes for an ``(N, V, C)`` view: ``BC`` channels a
    program (64, or the next power of two of a narrower C), ``BV`` rows a
    tile (4096 elements), and slabs of ``rows`` rows, a multiple of ``BV``,
    so that about :data:`TARGET_PROGRAMS` programs run the statistics."""
    bc = min(64, 1 << max(c - 1, 0).bit_length())
    bv = max(4096 // bc, 16)
    n_cb = -(-c // bc)
    want = max(1, TARGET_PROGRAMS // max(1, n * n_cb))
    rows = -(-max(1, -(-v // want)) // bv) * bv
    return {"BC": bc, "BV": bv, "n_cb": n_cb, "rows": rows, "nblk": -(-v // rows)}


def instance_norm_leaky(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        eps: float, slope: float,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """InstanceNorm (affine ``weight``, ``bias``; float32 statistics per
    sample and channel over D·H·W) then LeakyReLU(``slope``) of an
    ``(N, C, D, H, W)`` tensor, into ``out`` (may be ``x``) or a new tensor
    of ``x``'s type and layout. A CPU tensor goes to
    :func:`instance_norm_leaky_reference`; a CUDA tensor must be bf16 or
    float32 in ``channels_last_3d`` memory, and its calls are counted in
    ``instance_norm_leaky.launches`` (three kernels each)."""
    if x.ndim != 5:
        raise ValueError(f"expected (N, C, D, H, W), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return instance_norm_leaky_reference(x, weight, bias, eps, slope, out)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_leaky has no kernel for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"instance_norm_leaky takes bf16 or float32, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError("instance_norm_leaky needs channels_last_3d memory")
    if out is None:
        out = torch.empty_like(x, memory_format=torch.channels_last_3d)
    elif out is not x and (out.shape != x.shape or not out.is_contiguous(
            memory_format=torch.channels_last_3d)):
        raise ValueError("out must have x's shape in channels_last_3d memory")
    n, c = x.shape[:2]
    v = x.shape[2] * x.shape[3] * x.shape[4]
    if n * c * v == 0:
        return out
    stats, merge, apply = _build()
    p = launch_plan(n, v, c)
    w = weight.to(x.device, torch.float32).contiguous()
    b = bias.to(x.device, torch.float32).contiguous()
    part = torch.empty((n, p["nblk"], 2, c), dtype=torch.float32, device=x.device)
    ss = torch.empty((n, 2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stats[(n * p["nblk"], p["n_cb"])](x, part, v, c, p["rows"], p["nblk"],
                                          BV=p["BV"], BC=p["BC"], num_warps=4)
        merge[(n, p["n_cb"])](part, w, b, ss, v, c, p["rows"], p["nblk"], float(eps),
                              BB=32, BC=p["BC"], num_warps=4)
        apply[(-(-v // p["BV"]), n, p["n_cb"])](x, out, ss, v, c, float(slope),
                                                BV=p["BV"], BC=p["BC"], num_warps=4)
    count_launch(instance_norm_leaky)
    return out


instance_norm_leaky.launches = 0


def bytes_moved(n: int, c: int, v: int, elem: int = 2) -> int:
    """The bytes the normalisation must move: the input read once and the
    output written once (the bound of :func:`instance_norm_leaky`)."""
    return 2 * elem * n * c * v
