"""K4, the U-Net's bf16 convolution stage: CUDA C++ for Hopper beside its
plain torch version.

Replaces what XLA computes for the JAX U-Net's bf16 conv stage (no Pallas
kernel there: XLA's convolution and its fusion): ``_conv_acc32``
(``lungmask_tpu/models/unet.py:61-81``, ``lax.conv_general_dilated`` with
``preferred_element_type=float32``), the float32 bias of ``_conv``
(``:107-114``), then ``jnp.maximum(·, 0)``, ``_affine`` in float32 and
one ``astype(bfloat16)`` (``:167-172``)::

    y = cast(relu(conv(x, w) accumulated in float32 + b) * s + t)

or, bias only (the 1×1 projections), ``cast(conv + b)``; or ``conv + b``
in float32 (the residual block's second conv and its 1×1 path, which JAX
adds in float32). A bf16 torch convolution rounds its output to bf16
before the bias (:func:`conv_stage_cudnn`, the port's path before K4, kept
here as the yardstick and as the test that shows the fault): one bf16
element in seven of every stage then differs from JAX's.

What bounds it on the H100: operations. The U-Net's 18 3×3 convs do 3.08
TFLOP per 32-slice chunk at 256² (3.1 ms at 989 TFLOP/s bf16) against 2.0 GB
of activations (0.6 ms at 3.35 TB/s); only the first (cin = 1) and the 1×1
projections are bound by bytes. The kernel (``csrc/conv_stage.cu``) is an
implicit GEMM on ``mma.sync`` bf16 → float32 with 16-byte ``cp.async``
tiles in a four-slice ring and the epilogue in registers: the float32
accumulator never leaves the chip, and each output element is stored once,
where the cuDNN path stores the bf16 conv and then runs six elementwise
passes over it (cast, bias, ReLU, scale, shift, cast). Every output sums
its K products in one order whatever its tile, so banded and whole
forwards give the same bits.

Layouts: ``x`` NHWC bf16 (the contiguous NHWC view of the U-Net's
channels_last tensors), the weight as :func:`weight_layout` makes it
(``(cout, kh, kw, cin)`` bf16, contiguous), ``b``/``s``/``t`` float32
``(cout,)``. Build and binding as K1 (``ops/kernels/_nvcc.py``). The
wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises. It counts its launches in
``conv_stage.launches``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lungmask_tpu_torch.ops.kernels import _nvcc, count_launch

SOURCE = os.path.join(_nvcc.CSRC, "conv_stage.cu")
_LIB: Optional[ctypes.CDLL] = None
# The kernel's epilogues (csrc/conv_stage.cu).
BIAS, RELU_AFFINE, BIAS_F32 = 0, 1, 2


def weight_layout(w: torch.Tensor) -> torch.Tensor:
    """An OIHW convolution weight as K4 takes it: ``(cout, kh, kw, cin)``
    bf16, contiguous (K in the order ky, kx, c); a view, no copy, of a bf16
    weight in channels_last memory."""
    if w.ndim != 4:
        raise ValueError(f"weight_layout expects an OIHW weight, got {tuple(w.shape)}")
    return w.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def _mode(s, t, out_dtype) -> int:
    if (s is None) != (t is None):
        raise ValueError("conv_stage takes both s and t (ReLU + affine) or neither (bias only)")
    if out_dtype == torch.float32:
        if s is not None:
            raise ValueError("a float32 output is bias only")
        return BIAS_F32
    if out_dtype != torch.bfloat16:
        raise TypeError(f"conv_stage writes bfloat16 or float32, not {out_dtype}")
    return BIAS if s is None else RELU_AFFINE


def _epilogue(acc: torch.Tensor, b, s, t, out_dtype) -> torch.Tensor:
    """(acc + b), then ReLU and ``* s + t`` when given, cast once."""
    y = acc + b.view(1, -1, 1, 1)
    if s is not None:
        y = torch.relu(y) * s.view(1, -1, 1, 1) + t.view(1, -1, 1, 1)
    return y.to(out_dtype)


def conv_stage_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         s: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                         padding: Tuple[int, int] = (1, 1),
                         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain torch K4: the bf16 values of ``x`` (NHWC) and ``w``
    (:func:`weight_layout`) convolved in float32 (cuDNN's TF32 off), the
    float32 epilogue, one cast. NHWC out."""
    _mode(s, t, out_dtype)
    xc = x.float().permute(0, 3, 1, 2)
    wc = w.float().permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        acc = F.conv2d(xc, wc, padding=tuple(padding))
    return _epilogue(acc, b, s, t, out_dtype).permute(0, 2, 3, 1)


def conv_stage_cudnn(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     s: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                     padding: Tuple[int, int] = (1, 1),
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The port's stage before K4: torch's bf16 convolution (its output
    rounded to bf16), then the float32 epilogue and a cast. Not JAX's
    function; the yardstick of ``chip_smoke.py`` (``library_ms``) and the
    CPU test of the fault K4 repairs. NHWC out."""
    _mode(s, t, out_dtype)
    xc = x.permute(0, 3, 1, 2)
    acc = F.conv2d(xc, w.permute(0, 3, 1, 2), padding=tuple(padding)).float()
    return _epilogue(acc, b, s, t, out_dtype).permute(0, 2, 3, 1)


def bf16_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The distance of two bf16 tensors in representable steps (adjacent
    values are 1 apart, ±0 are equal), int32."""

    def ordered(v):
        bits = v.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


def rounding_scale(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   s: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                   padding: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """The scale of each output's float32 arithmetic, NHWC float32:
    ``|s|·(Σ|x·w| + |b|) + |t|``, or ``Σ|x·w| + |b|`` bias only. Two float32
    sums of the same products in other orders differ by a small multiple of
    2^-24 of it; an output that cancels far below it (``r·s + t ≈ 0``) can
    then lie more than one bf16 step from another order's
    (:func:`agreement`)."""
    mag = conv_stage_reference(x.abs(), w.abs(), b.abs(), padding=padding,
                               out_dtype=torch.float32)
    if s is None:
        return mag
    return mag * s.abs() + t.abs()


def agreement(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> dict:
    """How two bf16 stage outputs agree: ``max_steps``, the ``differing``
    share, the share of ``outliers`` (more than one step apart) and
    ``worst``, the largest ``|got − want|`` of an outlier over its
    :func:`rounding_scale` (0 without outliers). Two sums of one stage in
    other float32 orders agree within one step except at outliers, and
    there within ``SCALE_RTOL`` of the scale."""
    steps = bf16_steps(got, want)
    far = steps > 1
    worst = 0.0
    if bool(far.any()):
        worst = float(((got.float() - want.float()).abs()[far] / scale[far]).max())
    return {"max_steps": int(steps.max()) if steps.numel() else 0,
            "differing": float((steps > 0).float().mean()) if steps.numel() else 0.0,
            "outliers": float(far.float().mean()) if steps.numel() else 0.0, "worst": worst}


# Two float32 orders of a stage's sum: outliers within 2^-20 of the scale,
# ~10x above the worst sound order measured and far below a bf16 rounding
# before the bias (conv_stage_cudnn); PERF.md has the readings.
SCALE_RTOL = 2.0 ** -20


def build() -> ctypes.CDLL:
    """Compile (when missing or older than its source) and load K4."""
    global _LIB
    if _LIB is None:
        lib = _nvcc.build(SOURCE, "libconvstage")
        lib.lm_conv_stage.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 9
                                      + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.lm_conv_stage.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _checked(x, w, b, s, t, padding, out_dtype):
    """(mode, x, w, [b] or [b, s, t]), contiguous; raises on what the kernel does not
    take."""
    mode = _mode(s, t, out_dtype)
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"conv_stage expects NHWC x and a (cout, kh, kw, cin) weight, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv_stage takes bfloat16 x and weight, got {x.dtype}, {w.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_stage has no kernel for device {x.device}")
    cout, kh, kw, cin = w.shape
    if x.shape[3] != cin:
        raise ValueError(f"x has {x.shape[3]} channels, the weight {cin}")
    vecs = [b] + ([s, t] if mode == RELU_AFFINE else [])
    for v in vecs:
        if v.dtype != torch.float32 or tuple(v.shape) != (cout,):
            raise ValueError(f"bias and affine must be float32 ({cout},), got {v.dtype} "
                             f"{tuple(v.shape)}")
    for v in [w] + vecs:
        if v.device != x.device:
            raise ValueError(f"conv_stage's operands on {v.device} and {x.device}")
    ph, pw = padding
    if ph < 0 or pw < 0 or x.shape[1] + 2 * ph < kh or x.shape[2] + 2 * pw < kw:
        raise ValueError(f"padding {tuple(padding)} of {tuple(x.shape)} leaves no output for a "
                         f"{kh}x{kw} kernel")
    return mode, x.contiguous(), w.contiguous(), [v.contiguous() for v in vecs]


def conv_stage(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               s: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
               padding: Tuple[int, int] = (1, 1),
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K4: the bf16 convolution of NHWC ``x`` (N, H, W, cin) with ``w``
    (:func:`weight_layout`), zero ``padding`` (rows, columns), float32
    accumulation, ``+ b`` and, given ``s`` and ``t``, ReLU then ``* s +
    t``; one rounding to ``out_dtype`` (bf16; float32 for bias only). NHWC
    (N, H + 2 ph − kh + 1, W + 2 pw − kw + 1, cout), contiguous. Counts
    kernel launches in ``conv_stage.launches``."""
    mode, x, w, vecs = _checked(x, w, b, s, t, padding, out_dtype)
    if x.device.type == "cpu":
        return conv_stage_reference(x, w, b, s, t, padding, out_dtype).contiguous()
    n, h, wd, cin = x.shape
    cout, kh, kw, _ = w.shape
    ph, pw = padding
    y = torch.empty((n, h + 2 * ph - kh + 1, wd + 2 * pw - kw + 1, cout), dtype=out_dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    sv, tv = (vecs[1], vecs[2]) if mode == RELU_AFFINE else (None, None)
    device = x.get_device()
    rc = (_LIB or build()).lm_conv_stage(
        x.data_ptr(), w.data_ptr(), vecs[0].data_ptr(), sv.data_ptr() if sv is not None else None,
        tv.data_ptr() if tv is not None else None, y.data_ptr(), n, h, wd, cin, cout, kh, kw,
        ph, pw, mode, device, torch._C._cuda_getCurrentRawStream(device),
    )
    if rc != 0:
        raise RuntimeError(f"lm_conv_stage kernel launch failed: cudaError {rc}")
    count_launch(conv_stage)
    return y


conv_stage.launches = 0
