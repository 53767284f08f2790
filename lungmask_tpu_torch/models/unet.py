"""The R231 U-Net forward in PyTorch (counterpart of ``lungmask_tpu.models.unet``).

Production configuration of the reference (lungmask/mask.py:58-65):
``in_channels=1, depth=5, wf=6, padding=True, batch_norm=True,
up_mode='upsample', residual=False``. BatchNorm is folded at conversion time
into a per-channel affine (``models/convert.py``).

* Interface: NHWC input ``(N, H, W, 1)`` and NHWC logits ``(N, H, W, K)``,
  the JAX package's layout; inside, NCHW tensors in ``channels_last`` memory.
* Conv block: conv3x3 → ReLU → affine, twice (the reference's BN sits after
  the ReLU). In bf16 each stage is one launch of K4
  (``ops/kernels/conv_stage``): the bf16 convolution accumulated in float32,
  the float32 bias, ReLU and affine on that accumulator, one rounding to
  bf16 — JAX's ``_conv`` → ``maximum`` → ``_affine`` → ``astype``. The 1×1
  projections take K4 bias only; the residual variant's second convs and
  its 1×1 paths take its float32 output, added in float32 as in JAX. Where
  a gradient is recorded (the train step) the stage is K4's autograd
  Function (``conv_stage.ConvStage``), whose backward is JAX's: the
  epilogue's adjoint in float32, then ``_conv_acc32_bwd``'s bf16 dgrad
  and wgrad; so the bf16 train forward and its gradients are JAX's. An
  inference module keeps its bf16 conv weights in channels_last memory, so
  K4's ``(cout, kh, kw, cin)`` lay-out of them is a view; a trainable
  module's float32 weights are cast and laid out at each call, and the
  weight's bf16 cotangent goes back to them through that cast, as through
  JAX's ``w.astype(x.dtype)``. In float32 the conv is torch's (cuDNN, TF32
  off) and the epilogue runs on its output. Every ReLU takes JAX's
  gradient, half the cotangent at 0 (:func:`_relu`).
* Down path: 2×2 average pooling between levels, K2
  (``ops/kernels/stencil.avg_pool2``).
* Up path: bilinear ×2 with half-pixel centres, K3
  (``ops/kernels/stencil.bilinear_up2``), the 1×1 projection, the skip
  centre-cropped to the upsampled size, concat ``[up, skip]``, conv block.
  Both stencils run on the NHWC view (``permute(0, 2, 3, 1)``) of the
  channels_last tensors, which is contiguous, so no copy is made; on a CUDA
  tensor they launch the hand-written kernels, on a CPU tensor their plain
  versions.
* Head: the 1×1 classifier as a float32 matmul over channels (``_head``).

The reference's two other configurations, dispatched on the tree's keys as
the JAX package does (``models/convert.convert_state_dict`` writes them):

* ``residual`` (``"res"`` in a block): the down blocks are pre-activation —
  [ReLU → affine (``bn_pre``, in the activations' dtype) on all but the
  first] → conv → ReLU → affine → conv, plus the 1×1 conv + affine of the
  block's input — and each up block adds the 1×1 conv + affine of its
  concatenated input to its output (:class:`ResPath`);
* ``upconv`` (``"upconv"`` in an up block): the kernel-2 stride-2
  transposed conv in place of upsample + projection, one float32 matmul per
  pixel and a depth-to-space interleave (JAX's ``_upconv2``), bias added in
  float32. K2 still pools; K3 runs only where the tree has ``proj``.

``float32`` runs with cuDNN's TF32 turned off for the call
(``torch.backends.cudnn.flags``), so f32 logits are full float32 on a GPU.

The mesh's ``space`` axis: every block's forward takes either a tensor or
the height bands of one data row (``parallel.halo.Bands``), which it runs
layer by layer, each band on its own device with the weights copied there
(:func:`_each`). Only the 3×3 convolutions (:func:`_conv`), K3
(:func:`_up2`) and the skip's crop (:func:`_center_crop`) read across
bands; pooling, the 1×1 convolutions, the upconv, the head and the
elementwise epilogues stay inside each band. A tensor takes the same path
as before.

Two ways to hold the weights, one forward:

* inference (the default): buffers, the kernels pre-cast to the compute
  dtype (the JAX engine's ``_cast_kernels``), biases and affines float32;
* ``trainable=True``: float32 master weights as ``nn.Parameter``s (the
  folded-BN affines' scale and bias included, as in JAX's tree), each
  kernel cast to the activations' dtype at its convolution as JAX's
  ``w.astype(x.dtype)`` does. The stencils are autograd Functions whose
  backward is K2ᵀ / K3ᵀ on the GPU.

:meth:`UNet.tree` gives the weights (or gradients, or optimizer moments) as
the port tree of ``models/convert.from_jax_params``; :func:`init_params`
draws a fresh tree.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lungmask_tpu_torch.ops.kernels import conv_stage as k4
from lungmask_tpu_torch.ops.kernels import stencil

Params = Dict[str, Any]

IN_CHANNELS = 1
DEPTH = 5
WF = 6
BN_EPS = 1e-5  # torch.nn.BatchNorm2d default, folded at conversion time.


def encoder_channels(depth: int = DEPTH, wf: int = WF) -> List[int]:
    """Channel counts of the encoder levels: [64, 128, 256, 512, 1024]."""
    return [2 ** (wf + i) for i in range(depth)]


def _each(fn, x, *args):
    """``fn(x, *args)`` on a tensor; on ``parallel.halo.Bands``, on each
    band, with each tensor argument (a weight) copied to the band's
    device."""
    return fn(x, *args) if isinstance(x, torch.Tensor) else x.map(fn, *args)


def _center_crop(skip, up):
    """The reference's UNetUpBlock.center_crop (resunet.py:136-142) on NCHW:
    ``skip`` cropped to ``up``'s height and width, centred; a no-op at
    power-of-two sizes, load-bearing for odd input sizes. On bands, the
    cropped rows are split as ``up``'s bands are (``Bands.regrid``)."""
    if isinstance(up, torch.Tensor):
        h, w = up.shape[2], up.shape[3]
        sh, sw = skip.shape[2], skip.shape[3]
    else:
        h, w = sum(up.rows), up.parts[0].shape[3]
        sh, sw = sum(skip.rows), skip.parts[0].shape[3]
    if (sh, sw) == (h, w) and (isinstance(skip, torch.Tensor) or skip.rows == up.rows):
        return skip
    dy, dx = (sh - h) // 2, (sw - w) // 2
    if isinstance(skip, torch.Tensor):
        return skip[:, :, dy : dy + h, dx : dx + w]
    return skip.regrid(dy, up).map(lambda y: y[:, :, :, dx : dx + w])


def _hold(module: nn.Module, name: str, value: torch.Tensor, trainable: bool,
          dtype: torch.dtype, at: Tuple[str, str]) -> None:
    """Keep weight ``name``, which sits at ``at`` = (group, key) of the
    module's port tree: a float32 ``nn.Parameter`` of its own (trainable) or
    a buffer in ``dtype``, a conv weight in channels_last memory (its
    ``permute(0, 2, 3, 1)`` is K4's lay-out, contiguous)."""
    if trainable:
        module.register_parameter(name, nn.Parameter(value.detach().float().clone()))
    else:
        value = value.detach().to(dtype)
        if value.ndim == 4:
            value = value.contiguous(memory_format=torch.channels_last)
        module.register_buffer(name, value)
    if "tree_at" not in module.__dict__:
        module.tree_at = {}
    module.tree_at[name] = at


def _subtree(module: nn.Module, prefix: str, pick) -> Params:
    """The port tree of ``module``: its weights where :func:`_hold` put
    them, each as ``pick(state_dict name, weight)``, and its children's
    trees under their names (a ``ModuleList`` as a list)."""
    node: Params = {}
    for name, (group, key) in getattr(module, "tree_at", {}).items():
        node.setdefault(group, {})[key] = pick(prefix + name, getattr(module, name))
    for cname, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            node[cname] = [_subtree(c, f"{prefix}{cname}.{i}.", pick) for i, c in enumerate(child)]
        else:
            node[cname] = _subtree(child, f"{prefix}{cname}.", pick)
    return node


def _add_to(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (a + b).to(dtype)


def _vec(t: torch.Tensor) -> torch.Tensor:
    """A (C,) per-channel vector as (1, C, 1, 1)."""
    return t.view(1, -1, 1, 1)


def _conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, padding) -> torch.Tensor:
    return F.conv2d(x, w.to(x.dtype), padding=padding).float() + _vec(b)


def _conv(x, w: torch.Tensor, b: torch.Tensor):
    """A 3×3 (zero-padded; between bands, the neighbours' rows) or 1×1
    convolution in ``x``'s dtype (torch's), its output in float32 plus the
    float32 bias."""
    k = w.shape[-1] // 2
    if isinstance(x, torch.Tensor) or k == 0:
        return _each(_conv2d, x, w, b, k)
    return x.halo(_conv2d, w, b, (0, k), rows=k, zeros=True)


def _affine(x, s: torch.Tensor, t: torch.Tensor):
    """A folded BatchNorm in ``x``'s dtype (JAX's ``_affine``)."""
    return _each(lambda y, s, t: y * _vec(s).to(y.dtype) + _vec(t).to(y.dtype), x, s, t)


def _nhwc_op(y: torch.Tensor, op, *args) -> torch.Tensor:
    """``op(y, *args)`` (a kernel of ``ops/kernels``) on the NHWC view of an
    NCHW channels_last tensor, which is contiguous: no copy."""
    return op(y.permute(0, 2, 3, 1), *args).permute(0, 3, 1, 2)


def _relu(y: torch.Tensor) -> torch.Tensor:
    """``max(y, 0)`` with JAX's gradient: ``jnp.maximum`` gives each of its
    arguments half the cotangent at a tie, as ``torch.maximum`` does, where
    ``torch.relu`` gives 0."""
    return torch.maximum(y, y.new_zeros(()))


def _relu_affine(y: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return _relu(y) * _vec(s) + _vec(t)


def _k4(x: torch.Tensor, *operands) -> Callable:
    """K4 for one call: its autograd Function where a gradient is recorded
    through ``x`` or a weight, else the launch alone."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x,) + operands):
        return k4.ConvStage.apply
    return k4.conv_stage


def _stage(module: nn.Module, x, name: str, b: torch.Tensor, s: Optional[torch.Tensor] = None,
           t: Optional[torch.Tensor] = None, out_dtype: Optional[torch.dtype] = None):
    """The convolution by the module's weight ``name`` (3×3 zero-padded, or
    1×1) + ``b``, then, given ``s`` and ``t``, ReLU and the affine, cast to
    ``out_dtype`` (``x``'s dtype by default; float32 keeps the sum): in
    bf16 one K4 launch (:func:`_k4`), in float32 torch's convolution and
    the float32 epilogue. On bands, each band padded with its neighbours'
    rows."""
    w = getattr(module, name)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    k = w.shape[-1] // 2
    if x.dtype == torch.bfloat16:
        def op(y, wk, b, s, t, padding):
            return _nhwc_op(y, _k4(y, wk, b, s, t), wk, b, s, t, padding, out_dtype)

        wk = k4.weight_layout(w)
        if isinstance(x, torch.Tensor) or k == 0:
            return _each(op, x, wk, b, s, t, (k, k))
        return x.halo(op, wk, b, s, t, (0, k), rows=k, zeros=True)
    y = _conv(x, w, b)
    if s is not None:
        y = _each(_relu_affine, y, s, t)
    return _each(lambda y, dtype: y.to(dtype), y, out_dtype)


def _pool(x):
    """K2 (2×2 average pooling). On bands, each band's own rows: every band
    but the last must hold an even number of rows."""
    if not isinstance(x, torch.Tensor) and any(r % 2 for r in x.rows[:-1]):
        raise ValueError(
            f"bands of {x.rows} rows: every band but the last must start at a multiple "
            "of 2 ** (depth - 1) rows (parallel.mesh.split_bands)"
        )
    return _each(_nhwc_op, x, stencil.avg_pool2)


def _up2(x):
    """K3 (bilinear ×2). On bands, each band padded with a neighbour row on
    each inner side, its 2 output rows there cropped (``parallel.halo``)."""
    if isinstance(x, torch.Tensor):
        return _nhwc_op(x, stencil.bilinear_up2)
    return x.halo(_nhwc_op, stencil.bilinear_up2, rows=1, zeros=False, crop=2)


class ResPath(nn.Module):
    """The residual variant's skip path: 1×1 conv + affine, float32 out."""

    def __init__(self, p: Params, compute_dtype: torch.dtype, trainable: bool = False):
        super().__init__()
        _hold(self, "w", p["conv"]["w"], trainable, compute_dtype, ("conv", "w"))
        _hold(self, "b", p["conv"]["b"], trainable, torch.float32, ("conv", "b"))
        _hold(self, "s", p["bn"]["scale"], trainable, torch.float32, ("bn", "scale"))
        _hold(self, "t", p["bn"]["bias"], trainable, torch.float32, ("bn", "bias"))

    def forward(self, x):
        return _affine(_stage(self, x, "w", self.b, out_dtype=torch.float32), self.s, self.t)


class ConvBlock(nn.Module):
    """conv3x3 → ReLU → affine, twice; or, with ``"res"`` in the tree, the
    residual block (module docstring). Kernels OIHW, cast to the
    activations' dtype; biases and affines float32."""

    def __init__(self, p: Params, compute_dtype: torch.dtype, trainable: bool = False):
        super().__init__()
        for i in (1, 2):
            _hold(self, f"w{i}", p[f"conv{i}"]["w"], trainable, compute_dtype, (f"conv{i}", "w"))
            _hold(self, f"b{i}", p[f"conv{i}"]["b"], trainable, torch.float32, (f"conv{i}", "b"))
        # The residual block has no affine after its second conv.
        for bn in ("bn_pre", "bn1", "bn2"):
            if bn in p:
                _hold(self, f"s_{bn}", p[bn]["scale"], trainable, torch.float32, (bn, "scale"))
                _hold(self, f"t_{bn}", p[bn]["bias"], trainable, torch.float32, (bn, "bias"))
        self.res = ResPath(p["res"], compute_dtype, trainable) if "res" in p else None

    def forward(self, x):
        if self.res is None:
            x = _stage(self, x, "w1", self.b1, self.s_bn1, self.t_bn1)
            return _stage(self, x, "w2", self.b2, self.s_bn2, self.t_bn2)
        inp = x
        if hasattr(self, "s_bn_pre"):
            x = _affine(_each(_relu, x), self.s_bn_pre, self.t_bn_pre)
        x = _stage(self, x, "w1", self.b1, self.s_bn1, self.t_bn1)
        x = _stage(self, x, "w2", self.b2, out_dtype=torch.float32)
        return _each(_add_to, x, self.res(inp), inp.dtype)


def _upconv2(x: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor) -> torch.Tensor:
    """Kernel-2 stride-2 transposed conv (JAX ``unet._upconv2``): the output
    blocks do not overlap, so ``out[2i+dy, 2j+dx, o] = Σ_c x[i,j,c]·W[o,c,dy,dx]
    + b[o]`` is one matmul per pixel into 4·cout phase channels, multiplied
    in float32 (exact for bf16 values, as JAX accumulates), then
    interleaved."""
    n, cin, h, w = x.shape
    cout = wp.shape[0]
    k = wp.to(x.dtype).permute(1, 2, 3, 0).reshape(cin, 4 * cout).float()
    y = torch.matmul(x.permute(0, 2, 3, 1).float(), k)
    y = y.view(n, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, cout)
    return (y + bp).to(x.dtype).permute(0, 3, 1, 2)


class UpBlock(nn.Module):
    """Bilinear ×2 → 1×1 projection (or, with ``"upconv"``, the transposed
    conv) → centre-cropped skip concat → conv block [+ the residual path of
    the concat, with ``"res"``]."""

    def __init__(self, p: Params, compute_dtype: torch.dtype, trainable: bool = False):
        super().__init__()
        self.upconv = "upconv" in p
        up = "upconv" if self.upconv else "proj"
        _hold(self, "wp", p[up]["w"], trainable, compute_dtype, (up, "w"))
        _hold(self, "bp", p[up]["b"], trainable, torch.float32, (up, "b"))
        self.conv_block = ConvBlock(p["conv_block"], compute_dtype, trainable)
        self.res = ResPath(p["res"], compute_dtype, trainable) if "res" in p else None

    def forward(self, x, skip):
        if self.upconv:
            up = _each(_upconv2, x, self.wp, self.bp)
        else:
            up = _stage(self, _up2(x), "wp", self.bp)
        skip = _center_crop(skip, up)
        x = _each(lambda u, s: torch.cat([u, s], dim=1), up, skip)
        out = self.conv_block(x)
        if self.res is None:
            return out
        return _each(_add_to, out, self.res(x), out.dtype)


class UNet(nn.Module):
    """The production U-Net over a port parameter tree (see
    ``models/convert.from_jax_params``); ``trainable`` holds float32 master
    weights as parameters (module docstring)."""

    def __init__(self, params: Params, compute_dtype: torch.dtype = torch.float32,
                 trainable: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.down = nn.ModuleList(ConvBlock(p, compute_dtype, trainable) for p in params["down"])
        self.up = nn.ModuleList(UpBlock(p, compute_dtype, trainable) for p in params["up"])
        # Head (O, I, 1, 1) → (I, O) for the channel matmul; the weight is
        # cast to the compute dtype like every kernel, and multiplied in
        # float32 (exact for bf16 values), as the JAX head accumulates.
        w = params["last"]["w"]
        _hold(self, "wl", w[:, :, 0, 0].t().contiguous(), trainable, compute_dtype, ("last", "w"))
        _hold(self, "bl", params["last"]["b"], trainable, torch.float32, ("last", "b"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 1) NHWC → (N, H, W, K) float32 logits."""
        return self.logits(x)

    def logits(self, x, compute_dtype: Optional[torch.dtype] = None):
        """:meth:`forward` in ``compute_dtype`` (the model's by default). On
        the NHWC bands of one data row (``parallel.halo.Bands``), the NHWC
        logits' bands."""
        dtype = self.compute_dtype if compute_dtype is None else compute_dtype

        def nchw(y):
            return y.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)

        def head(y, wl, bl):
            return torch.matmul(y.permute(0, 2, 3, 1).float(), wl.to(dtype).float()) + bl

        with conv_flags(dtype):
            x = nchw(x) if isinstance(x, torch.Tensor) else x.map(nchw, dim=2)
            skips = []
            for i, block in enumerate(self.down):
                x = block(x)
                if i != len(self.down) - 1:
                    skips.append(x)
                    x = _pool(x)
            for i, block in enumerate(self.up):
                x = block(x, skips[-i - 1])
            if isinstance(x, torch.Tensor):
                return head(x, self.wl, self.bl)
            return x.map(head, self.wl, self.bl, dim=1)

    def tree(self, of: Optional[Dict[str, torch.Tensor]] = None) -> Params:
        """The port tree (OIHW kernels, (C,) vectors) of the weights this
        model holds, or, given ``of``, of those tensors (keyed by
        ``state_dict`` name and shaped like the weights: gradients,
        optimizer moments). Leaves are the tensors themselves or views of
        them (the head's transpose)."""
        tree = _subtree(self, "", lambda name, t: t if of is None else of[name])
        tree["last"]["w"] = tree["last"]["w"].t()[:, :, None, None]
        return tree


def conv_flags(compute_dtype: torch.dtype):
    """cuDNN's settings for a U-Net pass in ``compute_dtype``: TF32 off for
    float32, so f32 convolutions (forward and backward) are full float32 on
    a GPU."""
    if compute_dtype == torch.float32:
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
    return torch.backends.cudnn.flags(enabled=True)


def unet_logits(model: UNet, x: torch.Tensor) -> torch.Tensor:
    """Raw classifier logits (pre log-softmax), NHWC float32."""
    return model(x)


def unet_argmax(model: UNet, x: torch.Tensor) -> torch.Tensor:
    """Per-pixel class (uint8); argmax ∘ log_softmax == argmax, so the
    reference head's normalization is skipped. Ties go to the first class."""
    return torch.argmax(model(x), dim=-1).to(torch.uint8)


def init_params(
    n_classes: int,
    *,
    in_channels: int = IN_CHANNELS,
    depth: int = DEPTH,
    wf: int = WF,
    generator: torch.Generator,
) -> Params:
    """A random port tree with the architecture's shapes (JAX's
    ``unet.init_params``): each conv's weight and bias drawn
    U(−1/√fan_in, 1/√fan_in) (torch's Conv2d default) in JAX's HWIO shape,
    in JAX's order, from ``generator``, then laid out OIHW; folded-BN
    affines identity (scale 1, bias 0). float32 on the CPU. The numbers are
    not JAX's: the two draw from different generators."""
    chans = encoder_channels(depth, wf)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    def conv(kh, kw, cin, cout):
        bound = 1.0 / float(kh * kw * cin) ** 0.5
        w = uniform((kh, kw, cin, cout), bound)
        return {"w": w.permute(3, 2, 0, 1).contiguous(), "b": uniform((cout,), bound)}

    def affine(cout):
        return {"scale": torch.ones(cout), "bias": torch.zeros(cout)}

    def block(cin, cout):
        return {"conv1": conv(3, 3, cin, cout), "bn1": affine(cout),
                "conv2": conv(3, 3, cout, cout), "bn2": affine(cout)}

    down, prev = [], in_channels
    for c in chans:
        down.append(block(prev, c))
        prev = c
    up = []
    for i in reversed(range(depth - 1)):
        up.append({"proj": conv(1, 1, prev, chans[i]), "conv_block": block(2 * chans[i], chans[i])})
        prev = chans[i]
    return {"down": down, "up": up, "last": conv(1, 1, prev, n_classes)}


def n_classes_of(params: Params) -> int:
    """Number of output classes: the length of the final conv bias, as in
    the reference (lungmask/mask.py:56)."""
    return int(params["last"]["b"].shape[0])
