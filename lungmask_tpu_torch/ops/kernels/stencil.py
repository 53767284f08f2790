"""K2 and K3, the U-Net's pooling and upsampling, and their adjoints K2ᵀ
and K3ᵀ: CUDA C++ for Hopper beside their plain torch versions.

Replace the TPU kernels of ``lungmask_tpu/ops/pallas/stencil.py``:

* K2 ``avg_pool2_pallas`` (body ``_pool_kernel``): NHWC 2×2 stride-2 mean,
  the row pair summed first and then the column pair, in float32, ×0.25,
  one rounding to the input dtype. It computes ``unet._avg_pool2``; an odd H
  or W drops its last row or column, as that function's VALID window does.
* K3 ``bilinear_up2_pallas`` (body ``_up2_kernel``): NHWC bilinear ×2 with
  half-pixel centres — a row pass (``even = 0.25·prev + 0.75·cur``,
  ``odd = 0.75·cur + 0.25·next``, edge rows clamped) kept in float32, the
  same column pass, one rounding. It computes ``unet._bilinear_up2``.

K2ᵀ and K3ᵀ replace XLA's transposes of those two functions in the U-Net's
backward (the JAX package has no backward kernel): :func:`avg_pool2_bwd`
spreads ``0.25·g`` over each window, :func:`bilinear_up2_bwd` gathers the
four clamped taps per axis, the row pass first.

What bounds them on the H100: bytes — one read of each input element and
one write of each output element. The U-Net's four pools move 629 MB and
its four upsamples 1258 MB per 32-slice bf16 chunk at 256² (wf=6), 0.188 ms
and 0.376 ms at 3.35 TB/s; the adjoints move the same. K2
(``lungmask_tpu_torch/csrc/stencil.cu``) gives each thread one output
pixel over a 16-byte vector of channels, neighbouring threads on
neighbouring channels. K3 stages a clamped input tile in shared memory and
computes each row pass once; K3ᵀ mirrors it, staging the clamped gradient
window of a dx tile and computing each row-pass value once; their tile
plans are chosen here (:func:`up2_plan`, :func:`up2_bwd_plan`, cached per
shape) and passed to the launchers. K2ᵀ gives each thread one g vector,
read once, and its 2×2 quad of dx. Every product and sum is rounded as the
plain version rounds it (no FMA), so the kernels are bit-equal to
:func:`avg_pool2_reference`, :func:`bilinear_up2_reference`,
:func:`avg_pool2_bwd_reference` and :func:`bilinear_up2_bwd_reference` in
bf16 and float32.

Build and binding as K1 (``ops/kernels/_nvcc.py``). A launch costs the host
a ctypes call, an output allocation and the checks; :func:`_launch` takes
the raw handle of the current stream and one device index, and the C side
sets the device and the shared-memory limit only when they need it, since
at the train step's batch of 8 most launches are shorter than that host
work. Each wrapper takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises. Each counts its
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from lungmask_tpu_torch.ops.kernels import _nvcc, count_launch

SOURCE = os.path.join(_nvcc.CSRC, "stencil.cu")
_LIB: Optional[ctypes.CDLL] = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
UP2_SMEM_BUDGET = 56 * 1024  # K3's tile: up to four blocks per SM
UP2_BWD_SMEM_BUDGET = 44 * 1024  # K3ᵀ's tile: up to five blocks per SM
UP2_BWD_THREADS = 128  # K3ᵀ: one thread per dx row and channel vector of a tile
UP2_MAX_THREADS = 256


def avg_pool2_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain torch K2: (N, H, W, C) → (N, H//2, W//2, C), in float32 as
    ``(x00 + x10) + (x01 + x11)`` then ×0.25, cast once."""
    f = x.float()
    s = (f[:, 0:-1:2, 0:-1:2] + f[:, 1::2, 0:-1:2]) + (f[:, 0:-1:2, 1::2] + f[:, 1::2, 1::2])
    return (s * 0.25).to(x.dtype)


def _quarter_lerps(f: torch.Tensor, dim: int) -> torch.Tensor:
    """The ×2 phases along ``dim`` with clamped edges, interleaved:
    ``0.25·prev + 0.75·cur`` then ``0.75·cur + 0.25·next``."""
    n = f.shape[dim]
    prev = torch.cat([f.narrow(dim, 0, 1), f.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([f.narrow(dim, 1, n - 1), f.narrow(dim, n - 1, 1)], dim)
    even = 0.25 * prev + 0.75 * f
    odd = 0.75 * f + 0.25 * nxt
    shape = list(f.shape)
    shape[dim] *= 2
    return torch.stack([even, odd], dim + 1).reshape(shape)


def bilinear_up2_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain torch K3: (N, H, W, C) → (N, 2H, 2W, C), the row pass then the
    column pass in float32, cast once."""
    return _quarter_lerps(_quarter_lerps(x.float(), 1), 2).to(x.dtype)


def avg_pool2_bwd_reference(g: torch.Tensor, in_shape) -> torch.Tensor:
    """Plain torch K2ᵀ: the gradient (N, H//2, W//2, C) of K2's output →
    the gradient (N, H, W, C) of its input: ``0.25·g`` in float32 on each
    window's four pixels, 0 on a dropped last row or column, cast once."""
    n, h, w, c = in_shape
    ho, wo = h // 2, w // 2
    q = g.float() * 0.25
    dx = torch.zeros((n, h, w, c), dtype=q.dtype, device=g.device)
    for a in (0, 1):
        for b in (0, 1):
            dx[:, a : 2 * ho : 2, b : 2 * wo : 2] = q
    return dx.to(g.dtype)


def _quarter_lerps_adjoint(f: torch.Tensor, dim: int) -> torch.Tensor:
    """The adjoint of :func:`_quarter_lerps` along ``dim`` (2n → n):
    ``(0.25·f[2i−1] + 0.75·f[2i]) + (0.75·f[2i+1] + 0.25·f[2i+2])``, the
    outer taps clamped to [0, 2n)."""
    m = f.shape[dim]
    i2 = torch.arange(0, m, 2, device=f.device)

    def tap(idx):
        return f.index_select(dim, idx.clamp(0, m - 1))

    return (0.25 * tap(i2 - 1) + 0.75 * tap(i2)) + (0.75 * tap(i2 + 1) + 0.25 * tap(i2 + 2))


def bilinear_up2_bwd_reference(g: torch.Tensor) -> torch.Tensor:
    """Plain torch K3ᵀ: the gradient (N, 2H, 2W, C) of K3's output → the
    gradient (N, H, W, C) of its input, the row pass then the column pass
    in float32, cast once."""
    return _quarter_lerps_adjoint(_quarter_lerps_adjoint(g.float(), 1), 2).to(g.dtype)


@dataclass(frozen=True)
class Up2Plan:
    """A tiling of K3 (``backward`` false) or K3ᵀ over the smaller image of
    the pair, (N, H, W, C): K3's input, K3ᵀ's output. ``rows`` rows and
    ``tile_w`` columns of it per tile, ``cvt`` vectors of ``vec`` channels
    per slab, ``threads`` per block (a multiple of ``cvt``). Each block
    stages a clamped tile: (rows + 2) × (tile_w + 2) input pixels for K3,
    (2·rows + 2) × (2·tile_w + 2) gradient pixels for K3ᵀ."""

    vec: int
    rows: int
    tile_w: int
    cvt: int
    threads: int
    itemsize: int
    backward: bool = False

    @property
    def staged(self) -> Tuple[int, int]:
        """Rows and columns of the staged tile."""
        if self.backward:
            return 2 * self.rows + 2, 2 * self.tile_w + 2
        return self.rows + 2, self.tile_w + 2

    @property
    def smem_bytes(self) -> int:
        staged_rows, staged_cols = self.staged
        return staged_rows * staged_cols * self.cvt * self.vec * self.itemsize

    def grid(self, shape: Tuple[int, int, int, int]) -> Tuple[int, int, int, int]:
        """(images, row tiles, column tiles, channel slabs): one block each."""
        n, h, w, c = shape
        vectors = -(-c // self.vec)
        return n, -(-h // self.rows), -(-w // self.tile_w), -(-vectors // self.cvt)

    @property
    def args(self) -> Tuple[int, int, int, int, int]:
        """The fields the launcher takes after the dtype."""
        return self.vec, self.rows, self.tile_w, self.cvt, self.threads


def _vectors(c: int, itemsize: int, aligned: bool, slab: int) -> Tuple[int, int]:
    """(channels per access, vectors per slab): 16-byte vectors when C is a
    whole number of them and both bases are 16-byte ``aligned``, else
    single channels; a slab is up to ``slab`` vectors."""
    full = 16 // itemsize
    vec = full if aligned and c % full == 0 else 1
    return vec, min(-(-c // vec), slab)


def _fit(plan: Up2Plan, budget: int) -> Tuple[int, int]:
    """``plan``'s rows and columns, the columns and then the rows halved
    until its staged tile fits ``budget`` bytes."""
    rows, tile_w = plan.rows, plan.tile_w
    while tile_w > 1 and replace(plan, rows=rows, tile_w=tile_w).smem_bytes > budget:
        tile_w = -(-tile_w // 2)
    while rows > 1 and replace(plan, rows=rows, tile_w=tile_w).smem_bytes > budget:
        rows = -(-rows // 2)
    return rows, tile_w


@functools.lru_cache(maxsize=1024)
def up2_plan(shape: Tuple[int, int, int, int], itemsize: int, aligned: bool = True) -> Up2Plan:
    """K3's tile plan for an (N, H, W, C) input of ``itemsize``-byte
    elements. A slab is up to 32 vectors (a warp's 512 contiguous bytes);
    each thread slot takes output rows, two per input row: rows (at least
    8, more for narrow slabs) and columns (up to 16) halve until the staged
    tile fits ``UP2_SMEM_BUDGET``. Cached: a launch looks its plan up."""
    n, h, w, c = shape
    vec, cvt = _vectors(c, itemsize, aligned, 32)
    rows = min(h, max(8, UP2_MAX_THREADS // 2 // cvt))
    rows, tile_w = _fit(Up2Plan(vec, rows, min(w, 16), cvt, cvt, itemsize), UP2_SMEM_BUDGET)
    threads = cvt * min(2 * rows, max(1, UP2_MAX_THREADS // cvt))
    return Up2Plan(vec, rows, tile_w, cvt, threads, itemsize)


@functools.lru_cache(maxsize=1024)
def up2_bwd_plan(shape: Tuple[int, int, int, int], itemsize: int,
                 aligned: bool = True) -> Up2Plan:
    """K3ᵀ's tile plan for the (N, H, W, C) input gradient it writes, from
    a (N, 2H, 2W, C) gradient of ``itemsize``-byte elements. A slab is up
    to 8 vectors (128 contiguous bytes a pixel) and each thread slot takes
    one dx row of the tile, so a block has up to 128 / cvt rows (16 for a
    full slab) of 4 columns; columns, then rows, halve until the staged
    tile fits ``UP2_BWD_SMEM_BUDGET``. Of the tilings timed on the H100
    (``tools/stencil_turns.py --sweep``), this one was the fastest at every
    U-Net shape. Cached as :func:`up2_plan`."""
    n, h, w, c = shape
    vec, cvt = _vectors(c, itemsize, aligned, 8)
    rows = min(h, max(1, UP2_BWD_THREADS // cvt))
    rows, tile_w = _fit(Up2Plan(vec, rows, min(w, 4), cvt, cvt, itemsize, backward=True),
                        UP2_BWD_SMEM_BUDGET)
    threads = cvt * min(rows, UP2_BWD_THREADS // cvt)
    return Up2Plan(vec, rows, tile_w, cvt, threads, itemsize, backward=True)


def build() -> ctypes.CDLL:
    """Compile (when missing or older than its source) and load K2, K3 and
    their adjoints."""
    global _LIB
    if _LIB is None:
        lib = _nvcc.build(SOURCE, "libstencil")
        shape = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int64] * 4 + [ctypes.c_int]
        lib.lm_avg_pool2.argtypes = shape + [ctypes.c_int, ctypes.c_void_p]
        lib.lm_bilinear_up2.argtypes = shape + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.lm_avg_pool2_bwd.argtypes = shape + [ctypes.c_int, ctypes.c_void_p]
        lib.lm_bilinear_up2_bwd.argtypes = shape + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        for fn in (lib.lm_avg_pool2, lib.lm_bilinear_up2, lib.lm_avg_pool2_bwd,
                   lib.lm_bilinear_up2_bwd):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _checked(x: torch.Tensor, op: str) -> torch.Tensor:
    if x.ndim != 4:
        raise ValueError(f"{op} expects an NHWC (N, H, W, C) tensor, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op} takes bfloat16 or float32, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} has no kernel for device {x.device}")
    return x.contiguous()


def _launch(fn_name: str, x: torch.Tensor, y: torch.Tensor, *plan: int, shape=None) -> bool:
    """Launch a stencil kernel from ``x`` into ``y`` on the current stream
    of ``x``'s device (with a tile plan's fields after the dtype);
    ``shape`` is the (N, H, W, C) the kernel is told, ``x``'s by default.
    False when there is no work (an empty tensor)."""
    if y.numel() == 0:
        return False
    n, h, w, c = x.shape if shape is None else shape
    device = x.get_device()
    rc = getattr(_LIB or build(), fn_name)(
        x.data_ptr(), y.data_ptr(), n, h, w, c, _DTYPE_CODES[x.dtype], *plan, device,
        torch._C._cuda_getCurrentRawStream(device),
    )
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {rc}")
    return True


def _pool_forward(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return avg_pool2_reference(x)
    n, h, w, c = x.shape
    y = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    if _launch("lm_avg_pool2", x, y):
        count_launch(avg_pool2)
    return y


def _up_forward(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return bilinear_up2_reference(x)
    n, h, w, c = x.shape
    y = torch.empty((n, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    p = up2_plan((n, h, w, c), x.element_size(), (x.data_ptr() | y.data_ptr()) % 16 == 0)
    if _launch("lm_bilinear_up2", x, y, *p.args):
        count_launch(bilinear_up2)
    return y


def avg_pool2_bwd(g: torch.Tensor, in_shape) -> torch.Tensor:
    """K2ᵀ: the gradient (N, H//2, W//2, C) of :func:`avg_pool2`'s output →
    the gradient of its (N, H, W, C) input, contiguous NHWC (so the NCHW
    view the U-Net takes of it is channels_last). Counts kernel launches in
    ``avg_pool2_bwd.launches``."""
    g = _checked(g, "avg_pool2_bwd")
    n, h, w, c = in_shape
    if g.shape != (n, h // 2, w // 2, c):
        raise ValueError(f"gradient {tuple(g.shape)} does not fit an input of {tuple(in_shape)}")
    if g.device.type == "cpu":
        return avg_pool2_bwd_reference(g, in_shape)
    dx = torch.empty((n, h, w, c), dtype=g.dtype, device=g.device)
    if _launch("lm_avg_pool2_bwd", g, dx, shape=(n, h, w, c)):
        count_launch(avg_pool2_bwd)
    return dx


def bilinear_up2_bwd(g: torch.Tensor) -> torch.Tensor:
    """K3ᵀ: the gradient (N, 2H, 2W, C) of :func:`bilinear_up2`'s output →
    the gradient of its (N, H, W, C) input, contiguous NHWC. Counts kernel
    launches in ``bilinear_up2_bwd.launches``."""
    g = _checked(g, "bilinear_up2_bwd")
    n, h2, w2, c = g.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"gradient {tuple(g.shape)} is not of a ×2 upsample")
    if g.device.type == "cpu":
        return bilinear_up2_bwd_reference(g)
    shape = (n, h2 // 2, w2 // 2, c)
    dx = torch.empty(shape, dtype=g.dtype, device=g.device)
    p = up2_bwd_plan(shape, g.element_size(), (g.data_ptr() | dx.data_ptr()) % 16 == 0)
    if _launch("lm_bilinear_up2_bwd", g, dx, *p.args, shape=shape):
        count_launch(bilinear_up2_bwd)
    return dx


class _AvgPool2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.in_shape = tuple(x.shape)
        return _pool_forward(x)

    @staticmethod
    def backward(ctx, g):
        return avg_pool2_bwd(g, ctx.in_shape)


class _BilinearUp2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _up_forward(x)

    @staticmethod
    def backward(ctx, g):
        return bilinear_up2_bwd(g)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 average pooling of an NHWC tensor (bf16 or float32) →
    (N, H//2, W//2, C); differentiable (backward :func:`avg_pool2_bwd`).
    Counts kernel launches in ``avg_pool2.launches``."""
    return _AvgPool2.apply(_checked(x, "avg_pool2"))


def bilinear_up2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear ×2 upsampling (half-pixel centres) of an NHWC tensor (bf16 or
    float32) → (N, 2H, 2W, C); differentiable (backward
    :func:`bilinear_up2_bwd`). Counts kernel launches in
    ``bilinear_up2.launches``."""
    return _BilinearUp2.apply(_checked(x, "bilinear_up2"))


avg_pool2.launches = 0
bilinear_up2.launches = 0
avg_pool2_bwd.launches = 0
bilinear_up2_bwd.launches = 0
