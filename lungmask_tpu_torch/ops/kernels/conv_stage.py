"""K4, the U-Net's bf16 convolution stage: CUDA C++ for Hopper beside its
plain torch version, and the autograd Function the train forward runs.

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
element in seven of every stage then differs from JAX's. In the ReLU +
affine mode the kernel also writes, given ``z``, the float32
pre-activation ``acc + b`` that the backward reads.

What bounds it on the H100: operations at all but the first conv. The
U-Net's 18 3×3 convs do 3.08 TFLOP per 32-slice chunk at 256² (3.1 ms at
989 TFLOP/s bf16) against 2.0 GB of activations (0.6 ms at 3.35 TB/s);
the first (cin = 1, whose cost is its 268 MB of stores) and the 1×1
projections are bound by bytes. Three routes, chosen by shape
(:func:`route_of`), never by a failure:

* ``"direct"`` (``csrc/conv_stage_direct.cu``), cin under 8 with kernels
  up to 3×3 — the first conv and the residual variant's first 1×1
  path: no tensor cores and no K padding; a thread computes one pixel's 8
  channels with float32 multiply-adds on the CUDA cores and writes them as
  one 16-byte vector, a warp 512 contiguous bytes; a persistent grid walks
  row tiles staged in shared memory with their halo, the weights loaded
  once per block;
* ``"tma"`` (``csrc/conv_stage_sm90.cu``), cin a multiple of 64 and x and
  the weight on 16-byte boundaries — 21 of the U-Net's 22 stages and every
  band of them: an implicit GEMM on ``wgmma`` fed by TMA (256-pixel by
  128-channel tiles; a 4-D tensor map over NHWC x whose zero fill outside
  the image is the padding, a 2-D one over the weights, a ring of
  mbarriers, one producer thread and two consumer warpgroups, a
  persistent grid; at the wide 3×3 stages with cout ≤ 64 the tile with its
  halo is loaded once per channel slice and the nine taps read as shifted
  views of it);
* ``"mma"`` (``csrc/conv_stage.cu``), the rest (other cins, unaligned
  views), and any stage when forced (``_route="mma"``, the yardstick): an
  implicit GEMM on ``mma.sync`` with 16-byte ``cp.async`` tiles, or element
  loads where cin % 8 != 0.

All keep the float32 accumulator on the chip through the epilogue and
store each output once, and all hold K4's numerics: every output sums its
K products in one order, whatever its tile or band — the direct route
product by product in the order (ky, kx, c), the tensor cores' partials
added to the float32 accumulator by round-to-nearest adds in K order, 16
products a partial on the mma.sync route, 64 (one 64-channel slice) on the
TMA route — so banded and whole forwards give the same bits, and each
stays within K4's gate of the plain version (:func:`agreement`).

The train forward: :class:`ConvStage` is K4 under autograd, its backward
JAX's: the epilogue's adjoint in float32 (with ``jnp.maximum``'s 0.5 at
the ReLU's tie) and ``_conv_acc32_bwd`` (:func:`conv_acc32_bwd`: the
cotangent rounded once to bf16, dgrad and wgrad as bf16 convolutions with
a float32 accumulator, torch's ``convolution_backward``).

Layouts: ``x`` NHWC bf16 (the contiguous NHWC view of the U-Net's
channels_last tensors), the weight as :func:`weight_layout` makes it
(``(cout, kh, kw, cin)`` bf16, contiguous), ``b``/``s``/``t`` float32
``(cout,)``. Build and binding as K1 (``ops/kernels/_nvcc.py``), one
library per route. The wrapper takes the plain version only for a tensor
on the CPU; for a CUDA tensor it launches a kernel or raises. It counts
its launches in ``conv_stage.launches`` and each route's in
``ROUTES[route].launches``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from lungmask_tpu_torch.ops.kernels import _nvcc, count_launch

SOURCE = os.path.join(_nvcc.CSRC, "conv_stage.cu")
SOURCE_SM90 = os.path.join(_nvcc.CSRC, "conv_stage_sm90.cu")
SOURCE_DIRECT = os.path.join(_nvcc.CSRC, "conv_stage_direct.cu")
_LIBS: Dict[str, ctypes.CDLL] = {}
# The kernels' epilogues (csrc/conv_stage*.cu).
BIAS, RELU_AFFINE, BIAS_F32 = 0, 1, 2
# lm_conv_stage_tma's return codes beyond cudaError_t.
_ENCODE_FAILED, _NO_ENCODER = 100000, 200000
TMA_CIN = 64  # the TMA route's K slice: cin must be a multiple of it
DIRECT_CIN = 8  # the direct route takes cin below it ...
DIRECT_KSIZE = 3  # ... and kh, kw up to it (csrc/conv_stage_direct.cu)


class Route:
    """One of K4's three kernels: its library, its C entry point and its
    launch count."""

    def __init__(self, name: str, libname: str, source: str, symbol: str):
        self.name, self.libname, self.source, self.symbol = name, libname, source, symbol
        self.launches = 0


ROUTES = {"direct": Route("direct", "libconvstage_direct", SOURCE_DIRECT, "lm_conv_stage_direct"),
          "tma": Route("tma", "libconvstage_sm90", SOURCE_SM90, "lm_conv_stage_tma"),
          "mma": Route("mma", "libconvstage", SOURCE, "lm_conv_stage")}


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
                         out_dtype: torch.dtype = torch.bfloat16,
                         z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch K4: the bf16 values of ``x`` (NHWC) and ``w``
    (:func:`weight_layout`) convolved in float32 (cuDNN's TF32 off), the
    float32 epilogue, one cast. NHWC out; given ``z`` (ReLU + affine
    only), the float32 ``acc + b`` is copied into it."""
    if z is not None and s is None:
        raise ValueError("z is the ReLU + affine mode's pre-activation")
    _mode(s, t, out_dtype)
    xc = x.float().permute(0, 3, 1, 2)
    wc = w.float().permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        acc = F.conv2d(xc, wc, padding=tuple(padding))
    if z is not None:
        z.copy_((acc + b.view(1, -1, 1, 1)).permute(0, 2, 3, 1))
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


def build(route: str = "mma") -> ctypes.CDLL:
    """Compile (when missing or older than its source) and load one route's
    kernel (:data:`ROUTES`)."""
    if route not in _LIBS:
        r = ROUTES[route]
        lib = _nvcc.build(r.source, r.libname)
        fn = getattr(lib, r.symbol)  # one argument list for the three
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIBS[route] = lib
    return _LIBS[route]


def route_of(x: torch.Tensor, w: torch.Tensor) -> str:
    """The route that takes a stage (:data:`ROUTES`): ``"direct"`` where
    cin is under 8 and the kernel at most 3×3; ``"tma"`` where cin is a
    multiple of 64 and the contiguous ``x`` and weight start on 16-byte
    boundaries; else ``"mma"``."""
    _, kh, kw, cin = w.shape
    if cin < DIRECT_CIN and kh <= DIRECT_KSIZE and kw <= DIRECT_KSIZE:
        return "direct"
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return "tma" if cin % TMA_CIN == 0 and aligned else "mma"


def _checked(x, w, b, s, t, padding, out_dtype, z=None):
    """(mode, x, w, [b] or [b, s, t]), contiguous; raises on what the kernel does not
    take, ``z`` included."""
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
    if z is not None:
        shape = (x.shape[0], x.shape[1] + 2 * ph - kh + 1, x.shape[2] + 2 * pw - kw + 1, cout)
        if mode != RELU_AFFINE:
            raise ValueError("z is the ReLU + affine mode's pre-activation")
        if (z.dtype != torch.float32 or tuple(z.shape) != shape or z.device != x.device
                or not z.is_contiguous()):
            raise ValueError(f"z must be float32 {shape}, contiguous, on {x.device}; got "
                             f"{z.dtype} {tuple(z.shape)} on {z.device}")
    return mode, x.contiguous(), w.contiguous(), [v.contiguous() for v in vecs]


def conv_stage(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               s: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
               padding: Tuple[int, int] = (1, 1),
               out_dtype: torch.dtype = torch.bfloat16,
               z: Optional[torch.Tensor] = None, *, _route: Optional[str] = None) -> torch.Tensor:
    """K4: the bf16 convolution of NHWC ``x`` (N, H, W, cin) with ``w``
    (:func:`weight_layout`), zero ``padding`` (rows, columns), float32
    accumulation, ``+ b`` and, given ``s`` and ``t``, ReLU then ``* s +
    t``; one rounding to ``out_dtype`` (bf16; float32 for bias only). NHWC
    (N, H + 2 ph − kh + 1, W + 2 pw − kw + 1, cout), contiguous. ``z``, in
    the ReLU + affine mode, a float32 tensor of the output's shape that
    receives ``acc + b``. Counts kernel launches in ``conv_stage.launches``
    and in the route's (:func:`route_of`; for measurements, ``_route``
    forces one: ``"mma"`` takes any stage, the others only their own)."""
    mode, x, w, vecs = _checked(x, w, b, s, t, padding, out_dtype, z)
    if x.device.type == "cpu":
        return conv_stage_reference(x, w, b, s, t, padding, out_dtype, z).contiguous()
    routed = route_of(x, w)
    route = routed if _route is None else _route
    if route == "tma" and routed != "tma":
        raise ValueError(f"the TMA route takes cin % {TMA_CIN} == 0 and 16-byte aligned "
                         f"operands, not cin {w.shape[3]}")
    if route == "direct" and routed != "direct":
        raise ValueError(f"the direct route takes cin < {DIRECT_CIN} and kernels up to "
                         f"{DIRECT_KSIZE}x{DIRECT_KSIZE}, not a {tuple(w.shape[1:3])} kernel of "
                         f"cin {w.shape[3]}")
    n, h, wd, cin = x.shape
    cout, kh, kw, _ = w.shape
    ph, pw = padding
    y = torch.empty((n, h + 2 * ph - kh + 1, wd + 2 * pw - kw + 1, cout), dtype=out_dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    sv, tv = (vecs[1], vecs[2]) if mode == RELU_AFFINE else (None, None)
    device = x.get_device()
    args = (x.data_ptr(), w.data_ptr(), vecs[0].data_ptr(),
            sv.data_ptr() if sv is not None else None, tv.data_ptr() if tv is not None else None,
            y.data_ptr(), z.data_ptr() if z is not None else None, n, h, wd, cin, cout, kh, kw,
            ph, pw, mode)
    stream = torch._C._cuda_getCurrentRawStream(device)
    lib = _LIBS.get(route) or build(route)
    rc = getattr(lib, ROUTES[route].symbol)(*args, device, stream)
    if rc >= _NO_ENCODER:
        raise RuntimeError("lm_conv_stage_tma: the driver's cuTensorMapEncodeTiled was not "
                           "found (libcuda.so.1)")
    if rc >= _ENCODE_FAILED:
        raise RuntimeError(f"lm_conv_stage_tma: cuTensorMapEncodeTiled failed: CUresult "
                           f"{rc - _ENCODE_FAILED}")
    if rc != 0:
        raise RuntimeError(f"lm_conv_stage ({route} route) kernel launch failed: cudaError {rc}")
    count_launch(conv_stage)
    count_launch(ROUTES[route])
    return y


conv_stage.launches = 0


def conv_acc32_bwd(dz: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                   padding: Tuple[int, int], need: Tuple[bool, bool] = (True, True)):
    """JAX's ``_conv_acc32_bwd`` (``lungmask_tpu/models/unet.py:87-104``):
    the float32 cotangent ``dz`` (NHWC) of the float32 accumulator,
    rounded once to bf16, through the transpose of the dtype-uniform bf16
    convolution — dgrad and wgrad each accumulate in float32 and round
    their output once to bf16 (torch's ``convolution_backward``; cuDNN on
    the card). ``(dx NHWC, dw (cout, kh, kw, cin))``, bf16; None where
    ``need`` says so."""
    g = dz.to(torch.bfloat16).permute(0, 3, 1, 2)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g, x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), None, [1, 1], list(padding), [1, 1],
        False, [0, 0], 1, [bool(need[0]), bool(need[1]), False])
    return (None if dx is None else dx.permute(0, 2, 3, 1),
            None if dw is None else dw.permute(0, 2, 3, 1))


def relu_adjoint(g: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The cotangent of ``z`` through ``jnp.maximum(z, 0)``: ``g`` where z
    > 0, ``g / 2`` at the tie z == 0 (JAX splits it between the two
    arguments; ``torch.relu``'s is 0), 0 below."""
    return torch.where(z > 0, g, torch.where(z == 0, g * 0.5, torch.zeros_like(g)))


class ConvStage(torch.autograd.Function):
    """K4 under autograd: ``apply(x, w, b, s, t, padding, out_dtype)``, the
    arguments of :func:`conv_stage`. Forward: :func:`conv_stage`, in the
    ReLU + affine mode with the float32 ``z = acc + b`` kept for the
    backward. Backward, JAX's for ``_conv`` → ``maximum`` → ``_affine`` →
    ``astype``, in float32: with ``g`` the output's cotangent, ``dt = Σ g``,
    ``ds = Σ g·relu(z)``, ``dz = relu_adjoint(g·s, z)`` (``dz = g`` bias
    only), ``db = Σ dz`` (sums over N, H, W), then :func:`conv_acc32_bwd`.
    The weight's cotangent is bf16, as JAX's transpose of
    ``w.astype(x.dtype)`` takes it; autograd's cast carries it to the
    float32 master weight."""

    @staticmethod
    def forward(ctx, x, w, b, s, t, padding, out_dtype):
        z = None
        if s is not None and any(ctx.needs_input_grad[:5]):
            n, h, wd, _ = x.shape
            cout, kh, kw, _ = w.shape
            z = torch.empty((n, h + 2 * padding[0] - kh + 1, wd + 2 * padding[1] - kw + 1, cout),
                            dtype=torch.float32, device=x.device)
        y = conv_stage(x, w, b, s, t, padding, out_dtype, z)
        ctx.save_for_backward(x, w, s, z)
        ctx.padding = tuple(padding)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, s, z = ctx.saved_tensors
        g = gy.float()
        dims = (0, 1, 2)
        ds = dt = None
        if s is not None:
            dt = g.sum(dims)
            ds = (g * torch.relu(z)).sum(dims)
            dz = relu_adjoint(g * s, z)
        else:
            dz = g
        db = dz.sum(dims)
        dx, dw = conv_acc32_bwd(dz, x, w, ctx.padding, ctx.needs_input_grad[:2])
        return dx, dw, db, ds, dt, None, None
