"""K4 (the U-Net's bf16 conv stage) and its plain version, against the JAX
U-Net's stage: ``_conv`` (bf16 convolution with a float32 accumulator plus
the float32 bias) → ``jnp.maximum(·, 0)`` → ``_affine`` (float32) →
``astype(bfloat16)``; bias only for the 1×1 projection.

Tolerances, in bf16 steps (adjacent representable values are 1 apart):
* plain version vs JAX, on the CPU: at most 0.1% of the elements
  differing, each within 1 step — or, an outlier, within 2^-20 of its
  float32 arithmetic's scale (``conv_stage.rounding_scale``:
  ``|s|·(Σ|x·w| + |b|) + |t|``). Both sum the same float32 products in
  their own orders, so an element differs where the two sums straddle a
  bf16 rounding boundary; where the affine cancels (``r·s + t ≈ 0``, an
  output ~1e-4 of ``|t|``), the sums' float32 rounding of ~1e-6 of the
  scale is several steps of that tiny output. Such outliers are ~1e-5 of
  the elements.
* the port's stage before K4 (``conv_stage_cudnn``: torch's bf16
  convolution rounds before the bias) differs from JAX in at least 5% of
  the elements at every shape: the fault K4 repairs.
* on the card (``cuda``-marked): each route that takes a shape (the
  direct route where cin is under 8, the TMA route where cin is a multiple
  of 64, the mma.sync route always) against
  the plain version (float32 on the card, TF32 off) by the same rule, at
  the U-Net's shapes and at ragged ones; float32 outputs (bias only) and
  the ReLU + affine mode's float32 ``z`` within 1e-5 of the largest. Run
  there with
  ``python -m pytest --noconftest -m cuda tests/test_torch_conv_stage.py``;
  JAX is imported inside the parity tests only.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from lungmask_tpu_torch.ops.kernels import conv_stage as k4

# (cin, cout, H = W, k): the U-Net's stage kinds at small batch.
JAX_SHAPES = [(1, 64, 64, 3), (64, 64, 64, 3), (256, 128, 32, 3), (1024, 512, 16, 3)]
PROJECTION = (128, 64, 32, 1)  # the 1×1 projection after K3, bias only
MAX_DIFFERING = 1e-3  # share of elements one bf16 step apart
CUDNN_MIN_DIFFERING = 0.05
# The wf=6 U-Net's 22 stages (18 3×3 with ReLU + affine, 4 1×1 bias only):
# (cin, cout, H = W, k).
UNET_STAGES = (
    [(1, 64, 256, 3), (64, 64, 256, 3), (64, 128, 128, 3), (128, 128, 128, 3),
     (128, 256, 64, 3), (256, 256, 64, 3), (256, 512, 32, 3), (512, 512, 32, 3),
     (512, 1024, 16, 3), (1024, 1024, 16, 3)]
    + [(2 * c, c, h, 3) for c, h in ((512, 32), (256, 64), (128, 128), (64, 256))]
    + [(c, c, h, 3) for c, h in ((512, 32), (256, 64), (128, 128), (64, 256))]
    + [(2 * c, c, h, 1) for c, h in ((512, 32), (256, 64), (128, 128), (64, 256))]
)
# Ragged pixel counts and channels: partial M and N tiles, the scalar path
# (cin not a multiple of 8), an odd cout (single-channel stores); for the
# direct route a cout below one octet, rows wider than its 256-pixel tile
# with a partial third channel slab, and the residual variant's first 1×1
# path (cin 1 -> 64 at 256², K = 1).
RAGGED = [(1, 37, 45, 64, 96, 3), (2, 5, 7, 4, 3, 3), (1, 9, 130, 24, 200, 1),
          (3, 11, 13, 8, 130, 3), (1, 7, 300, 1, 130, 3), (2, 256, 256, 1, 64, 1)]


def _inputs(n, h, w, cin, cout, k, seed):
    """NHWC bf16 x, the HWIO float32 weight (its bf16 values), bias, scale
    and shift: weights U(±1/√fan_in), affines around identity."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, h, w, cin)).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    bound = 1.0 / np.sqrt(k * k * cin)
    whwio = rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32)
    whwio = torch.from_numpy(whwio).to(torch.bfloat16).float().numpy()
    b = rng.uniform(-bound, bound, cout).astype(np.float32)
    s = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    t = rng.uniform(-0.2, 0.2, cout).astype(np.float32)
    return x, whwio, b, s, t


def _torch_args(x, whwio, b, s, t, device="cpu"):
    wt = torch.from_numpy(np.ascontiguousarray(whwio.transpose(3, 0, 1, 2)))
    return [torch.from_numpy(a).to(device) for a in (x, b, s, t)], wt.to(torch.bfloat16).to(device)


def _jax_stage(x, whwio, b, s, t, relu_affine, padding="SAME"):
    import jax.numpy as jnp
    from jax import lax

    from lungmask_tpu.models import unet as junet

    xj = jnp.asarray(x).astype(jnp.bfloat16)
    if padding == "SAME":
        y = junet._conv(xj, jnp.asarray(whwio), jnp.asarray(b), precision=lax.Precision.DEFAULT)
    else:  # explicit ((top, bottom), (left, right)), as a band's
        y = junet._conv_acc32(xj, jnp.asarray(whwio).astype(jnp.bfloat16), padding,
                              lax.Precision.DEFAULT) + jnp.asarray(b)
    if relu_affine:
        y = junet._affine(jnp.maximum(y, 0.0), {"scale": jnp.asarray(s), "bias": jnp.asarray(t)})
    return torch.from_numpy(np.array(y.astype(jnp.float32))).to(torch.bfloat16)


def _check_close(got, want, args, what):
    """``got`` against ``want`` (bf16 stage outputs) by the module
    docstring's rule; ``args`` are the stage's (x, w, b, s, t, padding)."""
    assert got.shape == want.shape, what
    a = k4.agreement(got, want, k4.rounding_scale(*args))
    assert a["differing"] <= MAX_DIFFERING, f"{what}: {a}"
    assert a["worst"] <= k4.SCALE_RTOL, f"{what}: {a}"
    return a


@pytest.mark.parametrize("cin,cout,hw,k", JAX_SHAPES + [PROJECTION])
def test_plain_matches_jax(cin, cout, hw, k):
    x, whwio, b, s, t = _inputs(1, hw, hw, cin, cout, k, seed=cin + cout)
    relu_affine = k == 3
    want = _jax_stage(x, whwio, b, s, t, relu_affine)
    (xt, bt, st, tt), wt = _torch_args(x, whwio, b, s, t)
    aff = (st, tt) if relu_affine else (None, None)
    args = (xt.to(torch.bfloat16), wt, bt, *aff, (k // 2, k // 2))
    got = k4.conv_stage_reference(*args)
    assert got.dtype == torch.bfloat16
    _check_close(got, want, args, f"plain {cin}->{cout} {hw}² {k}x{k}")


@pytest.mark.parametrize("cin,cout,hw,k", JAX_SHAPES + [PROJECTION])
def test_cudnn_composition_shows_the_fault(cin, cout, hw, k):
    """torch's bf16 convolution rounds before the bias: ≥ 5% of the
    elements differ from JAX, where the plain version differs in ≤ 0.1%."""
    x, whwio, b, s, t = _inputs(1, hw, hw, cin, cout, k, seed=cin + cout)
    relu_affine = k == 3
    want = _jax_stage(x, whwio, b, s, t, relu_affine)
    (xt, bt, st, tt), wt = _torch_args(x, whwio, b, s, t)
    aff = (st, tt) if relu_affine else (None, None)
    args = (xt.to(torch.bfloat16), wt, bt, *aff, (k // 2, k // 2))
    old = k4.conv_stage_cudnn(*args[:5], padding=args[5])
    a = k4.agreement(old, want, k4.rounding_scale(*args))
    assert a["differing"] >= CUDNN_MIN_DIFFERING, f"only {a['differing']:.3%} differ"
    assert a["worst"] > k4.SCALE_RTOL, a  # its outliers fail the outlier limit too


@pytest.mark.parametrize("error,caught", [(2.0 ** -19, True), (2.0 ** -22, False)])
def test_outlier_limit_where_the_affine_cancels(error, caught):
    """An output where the affine cancels (``r·s + t ≈ 0``), moved by
    ``error`` of its float32 scale: caught above ``SCALE_RTOL`` (2^-20),
    passed below it."""
    x, whwio, b, s, t = _inputs(1, 32, 32, 64, 64, 3, seed=5)
    (xt, bt, st, tt), wt = _torch_args(x, whwio, b, s, t)
    args = (xt.to(torch.bfloat16), wt, bt, st, tt, (1, 1))
    want = k4.conv_stage_reference(*args)
    scale = k4.rounding_scale(*args)
    near = (want.float().abs() / scale).flatten()
    near[want.flatten() == 0] = float("inf")
    i = int(near.argmin())
    assert float(near[i]) < 2.0 ** -12  # |y| far below its scale: a step of it is tiny
    got = want.clone().flatten()
    got[i] = (want.flatten()[i].float() + error * scale.flatten()[i]).to(torch.bfloat16)
    a = k4.agreement(got.view_as(want), want, scale)
    assert a["max_steps"] > 1 and a["outliers"] > 0, a
    assert (a["worst"] > k4.SCALE_RTOL) == caught, a


def test_band_with_halo_rows_matches_jax():
    """A band of rows 8..24 of a 32-row image, padded with one neighbour
    row above and below and convolved with padding (0, 1), gives the
    whole image's rows within 1 step, and JAX's conv with the same explicit
    padding."""
    x, whwio, b, s, t = _inputs(2, 32, 20, 64, 64, 3, seed=7)
    whole = _jax_stage(x, whwio, b, s, t, True)
    band = x[:, 7:25]
    want = _jax_stage(band, whwio, b, s, t, True, padding=((0, 0), (1, 1)))
    (xt, bt, st, tt), wt = _torch_args(band, whwio, b, s, t)
    args = (xt.to(torch.bfloat16), wt, bt, st, tt, (0, 1))
    got = k4.conv_stage(*args)
    assert got.shape == (2, 16, 20, 64)
    _check_close(got, want, args, "band vs JAX's band")
    _check_close(got, whole[:, 8:24], args, "band vs JAX's whole image")


def test_wrapper_takes_plain_version_on_cpu():
    x, whwio, b, s, t = _inputs(2, 6, 10, 8, 16, 3, seed=3)
    (xt, bt, st, tt), wt = _torch_args(x, whwio, b, s, t)
    xb = xt.to(torch.bfloat16)
    before = k4.conv_stage.launches
    for aff, dtype in (((st, tt), torch.bfloat16), ((None, None), torch.bfloat16),
                       ((None, None), torch.float32)):
        got = k4.conv_stage(xb, wt, bt, *aff, out_dtype=dtype)
        assert got.dtype == dtype and got.shape == (2, 6, 10, 16) and got.is_contiguous()
        assert torch.equal(got, k4.conv_stage_reference(xb, wt, bt, *aff, out_dtype=dtype))
    # The NHWC view of a channels_last tensor goes in as it is.
    nchw = xb.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    assert torch.equal(k4.conv_stage(nchw.permute(0, 2, 3, 1), wt, bt, st, tt),
                       k4.conv_stage(xb, wt, bt, st, tt))
    assert k4.conv_stage.launches == before
    # weight_layout is (cout, kh, kw, cin), the HWIO weight's bf16 values.
    oihw = torch.from_numpy(np.ascontiguousarray(whwio.transpose(3, 2, 0, 1)))
    assert torch.equal(k4.weight_layout(oihw), wt)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, whwio, b, s, t = _inputs(1, 4, 4, 8, 16, 3, seed=4)
    (xt, bt, st, tt), wt = _torch_args(x, whwio, b, s, t)
    xb = xt.to(torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        k4.conv_stage(xt, wt, bt, st, tt)  # float32 x
    with pytest.raises(TypeError, match="bfloat16"):
        k4.conv_stage(xb, wt.float(), bt, st, tt)
    with pytest.raises(ValueError, match="NHWC"):
        k4.conv_stage(xb[0], wt, bt, st, tt)
    with pytest.raises(ValueError, match="channels"):
        k4.conv_stage(xb[..., :4], wt, bt, st, tt)
    with pytest.raises(ValueError, match="float32"):
        k4.conv_stage(xb, wt, bt[:8], st, tt)
    with pytest.raises(ValueError, match="float32"):
        k4.conv_stage(xb, wt, bt, st.to(torch.bfloat16), tt)
    with pytest.raises(ValueError, match="both s and t"):
        k4.conv_stage(xb, wt, bt, st, None)
    with pytest.raises(ValueError, match="bias only"):
        k4.conv_stage(xb, wt, bt, st, tt, out_dtype=torch.float32)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        k4.conv_stage(xb, wt, bt, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="no output"):
        k4.conv_stage(xb[:, :1], wt, bt, st, tt, padding=(0, 1))


def _kernel_vs_plain(dev, n, h, w, cin, cout, k, seed, mode, route):
    x, whwio, b, s, t = _inputs(n, h, w, cin, cout, k, seed)
    (xt, bt, st, tt), wt = _torch_args(x, whwio, b, s, t, dev)
    xb = xt.to(torch.bfloat16)
    aff = (st, tt) if mode == "relu_affine" else (None, None)
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    pad = (k // 2, k // 2)
    shape = (n, h, w, cout)
    z = torch.full(shape, float("nan"), device=dev) if mode == "relu_affine" else None
    zr = torch.empty(shape, device=dev) if mode == "relu_affine" else None
    before = k4.conv_stage.launches, k4.ROUTES[route].launches
    got = k4.conv_stage(xb, wt, bt, *aff, padding=pad, out_dtype=dtype, z=z, _route=route)
    want = k4.conv_stage_reference(xb, wt, bt, *aff, padding=pad, out_dtype=dtype, z=zr)
    torch.cuda.synchronize()
    assert (k4.conv_stage.launches, k4.ROUTES[route].launches) == (before[0] + 1, before[1] + 1)
    what = f"{(n, h, w, cin)} -> {cout} {k}x{k} {mode} ({route})"
    if z is not None:
        assert float((z - zr).abs().max()) <= 1e-5 * float(zr.abs().max()), what
    if dtype == torch.float32:  # two float32 sums in other orders
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale, what
    else:
        _check_close(got, want, (xb, wt, bt, *aff, (k // 2, k // 2)), what)


def _routes(cin):
    """The routes that take a 3×3 or 1×1 stage of ``cin`` channels (aligned
    operands)."""
    return ["mma"] + (["tma"] if cin % k4.TMA_CIN == 0 else []) + (
        ["direct"] if cin < k4.DIRECT_CIN else [])


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,hw,k,route", [s + (r,) for s in UNET_STAGES
                                                 for r in _routes(s[0])])
def test_kernel_matches_plain_at_unet_shapes(cin, cout, hw, k, route):
    dev = tp.cuda_device()
    _kernel_vs_plain(dev, 2, hw, hw, cin, cout, k, seed=cin + hw,
                     mode="relu_affine" if k == 3 else "bias", route=route)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,route", [(s, r) for s in RAGGED for r in _routes(s[3])])
@pytest.mark.parametrize("mode", ["relu_affine", "bias", "f32"])
def test_kernel_matches_plain_at_ragged_shapes(shape, route, mode):
    dev = tp.cuda_device()
    _kernel_vs_plain(dev, *shape, seed=sum(shape), mode=mode, route=route)


def test_route_of_by_shape():
    """cin 1 and 4 take the direct route, 8 the mma.sync route, 64 the TMA
    route; a view off a 16-byte boundary (cin 64) the mma.sync route."""
    def route(cin, k=3, offset=0):
        flat = torch.zeros(2 * 5 * 6 * cin + offset, dtype=torch.bfloat16)
        x = flat[offset:].view(2, 5, 6, cin)
        return k4.route_of(x, torch.zeros(16, k, k, cin, dtype=torch.bfloat16))

    assert [route(c) for c in (1, 4, 8, 64)] == ["direct", "direct", "mma", "tma"]
    assert route(64, offset=1) == "mma"
    assert route(7, k=3) == "direct" and route(1, k=1) == "direct"
    assert route(3, k=5) == "mma" and route(1, k=5) == "mma"  # past the direct route's 3×3


@pytest.mark.cuda
def test_direct_route_bands_are_bit_equal_to_the_whole_image():
    """Two (0, 1)-padded bands of a cin-1 image on the direct route: each
    band's output equals the whole image's rows bit for bit, as the U-Net's
    space axis needs (the neighbours' rows and the zero rows at the image's
    edge enter each sum as the whole image's taps do)."""
    dev = tp.cuda_device()
    x, whwio, b, s, t = _inputs(2, 64, 64, 1, 64, 3, seed=13)
    (xt, bt, st, tt), wt = _torch_args(x, whwio, b, s, t, dev)
    xb = xt.to(torch.bfloat16)
    whole = k4.conv_stage(xb, wt, bt, st, tt)
    rows = 32
    top = torch.cat([torch.zeros_like(xb[:, :1]), xb[:, : rows + 1]], dim=1)
    bottom = torch.cat([xb[:, rows - 1:], torch.zeros_like(xb[:, :1])], dim=1)
    before = k4.ROUTES["direct"].launches
    for i, band in enumerate((top, bottom)):
        got = k4.conv_stage(band, wt, bt, st, tt, padding=(0, 1))
        assert torch.equal(got.view(torch.int16),
                           whole[:, i * rows:(i + 1) * rows].view(torch.int16)), f"band {i}"
    assert k4.ROUTES["direct"].launches == before + 2


@pytest.mark.cuda
def test_routes_by_shape_never_by_failure():
    """The U-Net's stages take the TMA route where cin is a multiple of 64
    and the operands are 16-byte aligned, else the mma.sync route (the
    direct route below 8 channels); a view that starts off a 16-byte
    boundary takes the mma.sync route and gives the aligned call's bits;
    a forced route that does not take the shape raises."""
    dev = tp.cuda_device()
    x, whwio, b, s, t = _inputs(1, 8, 9, 64, 64, 3, seed=11)
    (xt, bt, st, tt), wt = _torch_args(x, whwio, b, s, t, dev)
    xb = xt.to(torch.bfloat16)
    assert k4.route_of(xb, wt) == "tma"
    assert k4.route_of(xb[..., :8], wt[..., :8].contiguous()) == "mma"
    flat = torch.empty(xb.numel() + 1, dtype=torch.bfloat16, device=dev)
    off = flat[1:].view(xb.shape)
    off.copy_(xb)
    assert k4.route_of(off, wt) == "mma"
    before = k4.ROUTES["mma"].launches
    got = k4.conv_stage(off, wt, bt, st, tt)
    assert k4.ROUTES["mma"].launches == before + 1
    assert torch.equal(got.view(torch.int16), k4.conv_stage(xb, wt, bt, st, tt,
                                                            _route="mma").view(torch.int16))
    with pytest.raises(ValueError, match="TMA route"):
        k4.conv_stage(off, wt, bt, st, tt, _route="tma")
    with pytest.raises(ValueError, match="direct route"):
        k4.conv_stage(xb, wt, bt, st, tt, _route="direct")


def _counted(monkeypatch):
    """Replace K4's wrapper by a counting one (the plain version runs, as on
    the CPU); returns the list of its calls' (kh, padding, out_dtype,
    ReLU + affine)."""
    calls = []
    real = k4.conv_stage

    def counted(x, w, b, s=None, t=None, padding=(1, 1), out_dtype=torch.bfloat16, z=None):
        calls.append((w.shape[1], tuple(padding), out_dtype, s is not None))
        return real(x, w, b, s, t, padding, out_dtype, z)

    monkeypatch.setattr(k4, "conv_stage", counted)
    return calls


@pytest.mark.parametrize("residual,up_mode,want", [(False, "upsample", 22), (True, "upsample", 31),
                                                   (False, "upconv", 18), (True, "upconv", 27)])
def test_unet_routes_its_bf16_inference_stages_through_k4(monkeypatch, residual, up_mode, want):
    """Every conv stage of a bf16 forward is one K4 call: 18 ReLU + affine
    stages and 4 bias-only projections in the production U-Net (the
    residual variant's down blocks add their second conv and 1×1 path, its
    up blocks the 1×1 path of their input, as float32 bias-only calls);
    under autograd the same calls, through K4's Function; none in
    float32."""
    from lungmask_tpu_torch.models import convert, synthetic, unet

    sd = synthetic.reference_state_dict(3, wf=2, residual=residual, up_mode=up_mode)
    tree = convert.from_jax_params(convert.convert_state_dict(sd))
    x = torch.from_numpy(np.random.default_rng(0).random((1, 32, 32, 1), np.float32))
    calls = _counted(monkeypatch)
    with torch.inference_mode():
        unet.UNet(tree, torch.bfloat16)(x)
    assert len(calls) == want
    relu_affine = [c for c in calls if c[3]]
    assert len(relu_affine) == (5 if residual else 10) + 8  # the up blocks' are plain
    assert all(c[:2] == (3, (1, 1)) and c[2] == torch.bfloat16 for c in relu_affine)
    if not residual:
        assert [c for c in calls if not c[3]] == [(1, (0, 0), torch.bfloat16, False)] * (
            0 if up_mode == "upconv" else 4)
    inference = list(calls)
    calls.clear()
    with torch.inference_mode():
        unet.UNet(tree, torch.float32)(x)
    assert calls == []
    trainable = unet.UNet(tree, torch.bfloat16, trainable=True)
    trainable(x).sum().backward()
    assert calls == inference
    assert all(p.grad is not None for p in trainable.parameters())


def test_inference_module_holds_its_conv_weights_in_k4_layout():
    """A bf16 inference module keeps each conv weight in channels_last
    memory, so K4's lay-out of it is a view (no copy per call), also after
    the module moved; a trainable module's float32 weights are cast."""
    from lungmask_tpu_torch.models import unet

    params = unet.init_params(3, depth=3, wf=2, generator=torch.Generator().manual_seed(0))
    for model in (unet.UNet(params, torch.bfloat16), unet.UNet(params, torch.bfloat16).to("cpu")):
        convs = [(n, w) for n, w in model.named_buffers() if w.ndim == 4]
        assert len(convs) == 3 * 2 + 2 * 3  # depth 3: 2 per block, a projection per up block
        for name, w in convs:
            wk = k4.weight_layout(w)
            assert wk.data_ptr() == w.data_ptr() and wk.is_contiguous(), name
            assert torch.equal(wk, w.permute(0, 2, 3, 1)), name
    trainable = unet.UNet(params, torch.bfloat16, trainable=True)
    w = trainable.down[0].w1
    assert w.dtype == torch.float32
    assert torch.equal(k4.weight_layout(w), w.to(torch.bfloat16).permute(0, 2, 3, 1))


def test_trainable_module_evaluates_with_its_weights_after_a_step(monkeypatch):
    """A trainable bf16 module evaluated under ``no_grad`` (``evaluate``)
    takes K4 with its weights as they are: after an in-place update its
    output equals a fresh module's on the updated weights."""
    from lungmask_tpu_torch.models import unet

    params = unet.init_params(3, depth=3, wf=2, generator=torch.Generator().manual_seed(0))
    model = unet.UNet(params, torch.bfloat16, trainable=True)
    x = torch.from_numpy(np.random.default_rng(1).random((2, 32, 32, 1), np.float32))
    calls = _counted(monkeypatch)
    with torch.no_grad():
        before = model(x)
        for p in model.parameters():
            p.mul_(1.5)
        after = model(x)
    fresh = unet.UNet(model.tree(), torch.bfloat16)
    with torch.inference_mode():
        want = fresh(x)
    assert len(calls) == 3 * 12  # depth 3: 6 stages down, 2 x 3 up
    assert not torch.equal(before, after)
    assert torch.equal(after, want)
