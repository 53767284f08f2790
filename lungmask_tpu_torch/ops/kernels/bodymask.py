"""K1, the fused bodymask kernel: CUDA C++ for Hopper beside its plain torch
version.

Replaces the TPU kernel ``lungmask_tpu/ops/pallas/bodymask.py``
(``bodymask_labels_pallas``, body ``_bodymask_kernel``): per 128² HU slice,
threshold > −500 HU → binary closing (cross) → hole fill (8-neighbour flood of
the complement from the border) → erosion ×2 (cross) → 4-connected labels
(root = raster-first linear index + 1). It is the hybrid preprocessing's
boxes step, ``transforms/preprocess.py::_boxes_from_packed``.

What bounds it on the H100: the chain of dependent steps per slice, not
bytes (28.3 MB at B=192, 8.5 µs at 3.35 TB/s). The kernel
(``lungmask_tpu_torch/csrc/bodymask.cu``) runs one 128-thread block per
slice, a thread per row held as 128 bits: the closing and erosions are word
shifts, the flood fills whole free runs per step by carry propagation and
straight vertical runs by warp-shuffle doubling, and the labels come from
union-find over horizontal runs in shared memory; see the source.

Build and binding: ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``lungmask_tpu_torch/_build/libbodymask.so`` on first use (rebuilt when the
source is newer; ``ops/kernels/_nvcc.py``), a plain C launcher loaded with
ctypes, launched on torch's current stream. :func:`bodymask_labels` takes
the plain version (:func:`bodymask_labels_reference`) only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from lungmask_tpu_torch.ops import cc, morphology
from lungmask_tpu_torch.ops.kernels import _nvcc, count_launch

BODY_THRESHOLD = -500  # HU (reference lungmask/utils.py:66)
N = 128  # bodymask resolution (reference lungmask/utils.py:68)

SOURCE = os.path.join(_nvcc.CSRC, "bodymask.cu")
_LIB: Optional[ctypes.CDLL] = None


def bodymask_labels_reference(small: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K1 from the ported morphology and cc:
    (B, 128, 128) HU → (labels int32, eroded mask bool)."""
    mask = small > BODY_THRESHOLD
    mask = morphology.binary_closing(mask)
    mask = morphology.binary_fill_holes(mask, structure="full")
    mask = morphology.binary_erosion(mask, iterations=2)
    return cc.label(mask, connectivity=1), mask


def build() -> ctypes.CDLL:
    """Compile (when missing or older than its source) and load K1."""
    global _LIB
    if _LIB is None:
        lib = _nvcc.build(SOURCE, "libbodymask")
        lib.lm_bodymask_labels.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.lm_bodymask_labels.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def bodymask_labels(small: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 128, 128) HU slices → (labels int32, eroded mask bool), fused.

    Labels are the 4-connected components of the post-erosion mask with
    root = raster-first linear index + 1 (identical to
    ``cc.label(mask, connectivity=1)``). A CPU tensor goes to
    :func:`bodymask_labels_reference`; a CUDA tensor to the kernel, whose
    launches are counted in ``bodymask_labels.launches``.
    """
    if small.ndim != 3 or tuple(small.shape[1:]) != (N, N):
        raise ValueError(f"expected (B, {N}, {N}) slices, got {tuple(small.shape)}")
    small = small.to(torch.float32).contiguous()
    if small.device.type == "cpu":
        return bodymask_labels_reference(small)
    if small.device.type != "cuda":
        raise ValueError(f"bodymask_labels has no kernel for device {small.device}")
    lib = build()
    b = small.shape[0]
    labels = torch.empty((b, N, N), dtype=torch.int32, device=small.device)
    mask = torch.empty((b, N, N), dtype=torch.uint8, device=small.device)
    if b:
        stream = torch.cuda.current_stream(small.device).cuda_stream
        rc = lib.lm_bodymask_labels(
            small.data_ptr(), labels.data_ptr(), mask.data_ptr(), b,
            small.device.index, stream,
        )
        if rc != 0:
            raise RuntimeError(f"bodymask kernel launch failed: cudaError {rc}")
        count_launch(bodymask_labels)
    return labels, mask.bool()


bodymask_labels.launches = 0
