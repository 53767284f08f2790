"""K2 and K3, the U-Net's pooling and upsampling: CUDA C++ for Hopper beside
their plain torch versions.

Replace the TPU kernels of ``lungmask_tpu/ops/pallas/stencil.py``:

* K2 ``avg_pool2_pallas`` (body ``_pool_kernel``): NHWC 2×2 stride-2 mean,
  the row pair summed first and then the column pair, in float32, ×0.25,
  one rounding to the input dtype. It computes ``unet._avg_pool2``; an odd H
  or W drops its last row or column, as that function's VALID window does.
* K3 ``bilinear_up2_pallas`` (body ``_up2_kernel``): NHWC bilinear ×2 with
  half-pixel centres — a row pass (``even = 0.25·prev + 0.75·cur``,
  ``odd = 0.75·cur + 0.25·next``, edge rows clamped) kept in float32, the
  same column pass, one rounding. It computes ``unet._bilinear_up2``.

What bounds them on the H100: bytes — one read of each input element and
one write of each output element. The U-Net's four pools move 629 MB and
its four upsamples 1258 MB per 32-slice bf16 chunk at 256² (wf=6), 0.188 ms
and 0.376 ms at 3.35 TB/s. K2 (``lungmask_tpu_torch/csrc/stencil.cu``)
gives each thread one output pixel over a 16-byte vector of channels,
neighbouring threads on neighbouring channels. K3 stages a clamped input
tile in shared memory and computes each row pass once; its tile plan is
chosen here (:func:`up2_plan`) and passed to the launcher. Every product
and sum is rounded as the plain version rounds it (no FMA), so the kernels
are bit-equal to :func:`avg_pool2_reference` and
:func:`bilinear_up2_reference` in bf16 and float32.

Build and binding as K1 (``ops/kernels/_nvcc.py``). :func:`avg_pool2` and
:func:`bilinear_up2` take the plain version only for a tensor on the CPU;
for a CUDA tensor they launch the kernel or raise. Each counts its launches
in ``.launches``.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from lungmask_tpu_torch.ops.kernels import _nvcc, count_launch

SOURCE = os.path.join(_nvcc.CSRC, "stencil.cu")
_LIB: Optional[ctypes.CDLL] = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
UP2_SMEM_BUDGET = 56 * 1024  # K3's tile: up to four blocks per SM
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


@dataclass(frozen=True)
class Up2Plan:
    """K3's tiling of an (N, H, W, C) input: ``rows`` input rows and
    ``tile_w`` input columns per tile, ``cvt`` vectors of ``vec`` channels
    per slab, ``threads`` per block (a multiple of ``cvt``). Each block
    stages a clamped (rows + 2) × (tile_w + 2) × slab tile."""

    vec: int
    rows: int
    tile_w: int
    cvt: int
    threads: int
    itemsize: int

    @property
    def smem_bytes(self) -> int:
        return (self.rows + 2) * (self.tile_w + 2) * self.cvt * self.vec * self.itemsize

    def grid(self, shape: Tuple[int, int, int, int]) -> Tuple[int, int, int, int]:
        """(images, row tiles, column tiles, channel slabs): one block each."""
        n, h, w, c = shape
        vectors = -(-c // self.vec)
        return n, -(-h // self.rows), -(-w // self.tile_w), -(-vectors // self.cvt)


def up2_plan(shape: Tuple[int, int, int, int], itemsize: int, aligned: bool = True) -> Up2Plan:
    """K3's tile plan for an (N, H, W, C) input of ``itemsize``-byte
    elements. 16-byte vectors when C is a whole number of them and both
    bases are 16-byte ``aligned``, else single channels. A slab is up to 32
    vectors (a warp's 512 contiguous bytes). Rows (at least 8, more for
    narrow slabs) and columns (up to 16) halve until the staged tile fits
    ``UP2_SMEM_BUDGET``."""
    n, h, w, c = shape
    full = 16 // itemsize
    vec = full if aligned and c % full == 0 else 1
    cvt = min(-(-c // vec), 32)
    rows = min(h, max(8, UP2_MAX_THREADS // 2 // cvt))
    tile_w = min(w, 16)

    def size(r, tw):
        return (r + 2) * (tw + 2) * cvt * vec * itemsize

    while tile_w > 1 and size(rows, tile_w) > UP2_SMEM_BUDGET:
        tile_w = -(-tile_w // 2)
    while rows > 1 and size(rows, tile_w) > UP2_SMEM_BUDGET:
        rows = -(-rows // 2)
    threads = cvt * min(2 * rows, max(1, UP2_MAX_THREADS // cvt))
    return Up2Plan(vec=vec, rows=rows, tile_w=tile_w, cvt=cvt, threads=threads, itemsize=itemsize)


def build() -> ctypes.CDLL:
    """Compile (when missing or older than its source) and load K2 and K3."""
    global _LIB
    if _LIB is None:
        lib = _nvcc.build(SOURCE, "libstencil")
        shape = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int64] * 4 + [ctypes.c_int]
        lib.lm_avg_pool2.argtypes = shape + [ctypes.c_int, ctypes.c_void_p]
        lib.lm_bilinear_up2.argtypes = shape + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        for fn in (lib.lm_avg_pool2, lib.lm_bilinear_up2):
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


def _launch(fn_name: str, x: torch.Tensor, y: torch.Tensor, *plan: int) -> bool:
    """Launch a stencil kernel from ``x`` into ``y`` (with K3's tile plan
    fields after the dtype); False when there is no work (an empty
    tensor)."""
    if y.numel() == 0:
        return False
    fn = getattr(build(), fn_name)
    n, h, w, c = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(
        x.data_ptr(), y.data_ptr(), n, h, w, c, _DTYPE_CODES[x.dtype], *plan,
        x.device.index, stream,
    )
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {rc}")
    return True


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 average pooling of an NHWC tensor (bf16 or float32) →
    (N, H//2, W//2, C). Counts kernel launches in ``avg_pool2.launches``."""
    x = _checked(x, "avg_pool2")
    if x.device.type == "cpu":
        return avg_pool2_reference(x)
    n, h, w, c = x.shape
    y = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    if _launch("lm_avg_pool2", x, y):
        count_launch(avg_pool2)
    return y


def bilinear_up2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear ×2 upsampling (half-pixel centres) of an NHWC tensor (bf16 or
    float32) → (N, 2H, 2W, C). Counts kernel launches in
    ``bilinear_up2.launches``."""
    x = _checked(x, "bilinear_up2")
    if x.device.type == "cpu":
        return bilinear_up2_reference(x)
    n, h, w, c = x.shape
    y = torch.empty((n, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    p = up2_plan((n, h, w, c), x.element_size(), (x.data_ptr() | y.data_ptr()) % 16 == 0)
    if _launch("lm_bilinear_up2", x, y, p.vec, p.rows, p.tile_w, p.cvt, p.threads):
        count_launch(bilinear_up2)
    return y


avg_pool2.launches = 0
bilinear_up2.launches = 0
