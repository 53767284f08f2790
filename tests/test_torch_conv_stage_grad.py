"""The bf16 train forward through K4's autograd Function
(``conv_stage.ConvStage``) and its backward, against the JAX package's bf16
U-Net and ``jax.grad``, on a narrow U-Net (depth 3, wf 2) at 64², batch 2,
on the CPU.

JAX's U-Net pools and upsamples in bf16 with XLA's own ops; its Pallas
kernels, which K2 and K3 port, sum in float32 and round once, but
``pallas_call`` has no VJP. The tests therefore replace JAX's
``_avg_pool2`` and ``_bilinear_up2``, in these tests only, by
differentiable forms that compute in float32 and cast once, and first check
that those equal the Pallas kernels (interpret mode) bit for bit on the
inputs the forward gives them. The residual variant's ``bn_pre`` affine
runs in bf16 (JAX's ``_affine`` in the activations' dtype), and XLA on the
CPU sums its scale's and bias's cotangents in bf16 (up to 258 bf16 steps
from a float32 sum here), where torch sums a bf16 tensor in float32 and
rounds once: ``_affine`` is replaced too, by the same forward whose bf16
parameter cotangents are summed in float32 and rounded once.

Tolerances:
* each K4 stage of the port's bf16 train forward against JAX's stage on the
  same inputs: K4's gate (``conv_stage.agreement``: at most 0.1% of the
  outputs a bf16 step apart, an outlier within 2^-20 of its float32 scale);
  the logits within 1e-5 of the largest |logit| (measured: bit for bit in
  the plain U-Net, 7e-8 in the variants, whose float32 sums and upconv
  matmul run in another order);
* one bf16 step's gradients against ``jax.grad`` of the same loss: at most
  1% of a bf16-valued leaf's elements (the conv and head weights, whose
  cotangents both packages round to bf16) more than one bf16 step from
  JAX's (measured: 0 in the plain U-Net, 0.43% in the upconv variant,
  where the forward's float32 orders reach the backward); every float32
  leaf (biases, affines) within 1e-3 of its largest |gradient| (measured
  ≤ 1.1e-4); the residual variant's ``bn_pre`` scale and bias, whose
  cotangents both packages round to bf16, with the weights' gate (these
  leaves hold 4 or 8 elements, so none may be more than one step off;
  measured: at most one step). The port's stage before K4 (torch's bf16 convolution, rounding before the
  bias; ReLU's gradient 0 at 0) fails the same gate in every variant.
* ``z`` and ``remat``: exact; the ReLU tie: the float32 cotangents within
  1e-6 of their largest, the bf16 ones within one step; the banded step:
  its test's docstring.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from lungmask_tpu_torch.models import convert, synthetic, unet
from lungmask_tpu_torch.ops.kernels import conv_stage as k4
from lungmask_tpu_torch.train import cross_entropy_loss, dice_loss, init_train_state
from lungmask_tpu_torch.train import make_train_step

DEPTH, WF, CLASSES = 3, 2, 3
MAX_DIFFERING = 1e-3  # K4's gate, per stage
LOGIT_RTOL = 1e-5
GRAD_FAR_SHARE = 1e-2  # a bf16-valued leaf: share of elements more than one step off
GRAD_F32_RTOL = 1e-3  # a float32 leaf: of its largest |gradient|
VARIANTS = ("plain", "residual", "upconv")


def _params(variant):
    """JAX-layout numpy weights: JAX's init with affines around identity
    (plain), or a seeded reference-layout state dict (the variants)."""
    if variant != "plain":
        sd = synthetic.reference_state_dict(CLASSES, depth=DEPTH, wf=WF,
                                            residual=variant == "residual",
                                            up_mode="upconv" if variant == "upconv"
                                            else "upsample", seed=4)
        return convert.convert_state_dict(sd)
    import jax

    from lungmask_tpu.models import unet as junet

    params = jax.tree_util.tree_map(
        np.asarray, junet.init_params(jax.random.PRNGKey(0), CLASSES, depth=DEPTH, wf=WF))
    rng = np.random.default_rng(0)

    def perturb(node):
        if isinstance(node, list):
            return [perturb(v) for v in node]
        if "scale" in node:
            return {"scale": rng.uniform(0.5, 1.5, node["scale"].shape).astype(np.float32),
                    "bias": rng.uniform(-0.2, 0.2, node["bias"].shape).astype(np.float32)}
        return {k: perturb(v) if isinstance(v, (dict, list)) else v for k, v in node.items()}

    return perturb(params)


def _batch(seed=0, n=2):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, CLASSES, (n, 64, 64)).astype(np.int32)
    labels[:, 20:44, 16:48] = 1
    return tp.blocky_slices(n, 64, 64, seed), labels


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, np.array(tree)


def _once_pool(x):
    """2×2 average pooling in float32, one cast (as the Pallas kernel)."""
    import jax.numpy as jnp
    from jax import lax

    s = lax.reduce_window(x.astype(jnp.float32), 0.0, lax.add, (1, 2, 2, 1), (1, 2, 2, 1),
                          "VALID")
    return (s * 0.25).astype(x.dtype)


def _once_up(x):
    """Bilinear ×2 in float32, one cast (as the Pallas kernel)."""
    import jax
    import jax.numpy as jnp

    n, h, w, c = x.shape
    return jax.image.resize(x.astype(jnp.float32), (n, 2 * h, 2 * w, c),
                            method="bilinear").astype(x.dtype)


def _affine_f32_sums(x, p):
    """JAX's ``_affine`` (``x * scale + bias`` in the dtype of ``x``), the
    same forward; for a bf16 ``x`` the cotangents of scale and bias are
    summed in float32 and rounded once to bf16 (as torch sums a bf16
    tensor), where XLA on the CPU sums them in bf16."""
    import jax
    import jax.numpy as jnp

    if x.dtype != jnp.bfloat16:
        return x * p["scale"].astype(x.dtype) + p["bias"].astype(x.dtype)

    @jax.custom_vjp
    def affine(x, s, t):
        return x * s.astype(x.dtype) + t.astype(x.dtype)

    def fwd(x, s, t):
        return affine(x, s, t), (x, s)

    def bwd(res, g):
        x, s = res
        dims = tuple(range(x.ndim - 1))

        def summed(v):
            return v.astype(jnp.float32).sum(dims).astype(x.dtype).astype(jnp.float32)

        return g * s.astype(x.dtype), summed(g * x), summed(g)

    affine.defvjp(fwd, bwd)
    return affine(x, p["scale"], p["bias"])


@pytest.fixture(scope="module")
def jax_runs():
    """Per variant: JAX's bf16 logits, loss and gradients (``jax.grad`` of
    0.5 CE + 0.5 Dice) with the once-rounding stencils, and the stencils'
    inputs of that forward."""
    import jax
    import jax.numpy as jnp

    from lungmask_tpu.models import unet as junet
    from lungmask_tpu.train import trainer as jtrainer

    images, labels = _batch()
    seen = {"pool": [], "up": []}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        def pool(x):
            seen["pool"].append(np.asarray(x.astype(jnp.float32)))
            return _once_pool(x)

        def up(x):
            seen["up"].append(np.asarray(x.astype(jnp.float32)))
            return _once_up(x)

        for variant in VARIANTS:
            params = _params(variant)

            def loss(p, x, y):
                lg = junet.unet_logits(p, x, compute_dtype=jnp.bfloat16)
                return (0.5 * jtrainer.cross_entropy_loss(lg, y)
                        + 0.5 * jtrainer.dice_loss(lg, y)), lg

            mp.setattr(junet, "_avg_pool2", _once_pool)
            mp.setattr(junet, "_bilinear_up2", _once_up)
            mp.setattr(junet, "_affine", _affine_f32_sums)
            (jl, jlg), jg = jax.value_and_grad(loss, has_aux=True)(
                params, jnp.asarray(images), jnp.asarray(labels))
            if variant == "plain":  # record the stencils' inputs once, eagerly
                mp.setattr(junet, "_avg_pool2", pool)
                mp.setattr(junet, "_bilinear_up2", up)
                junet.unet_logits(params, jnp.asarray(images), compute_dtype=jnp.bfloat16)
            out[variant] = {"params": params, "loss": float(jl), "logits": np.asarray(jlg),
                            "grads": dict(_leaves(jax.tree_util.tree_map(np.asarray, jg)))}
    out["stencil_inputs"] = seen
    return out


def _port_step(params, old=False, record=None):
    """The port's bf16 forward and backward of the same loss on a trainable
    model: (loss, logits, gradient leaves). ``old``: each stage as the port
    ran it before K4 (torch's bf16 convolution under autograd);
    ``record``: a list that receives each K4 stage's arguments and
    output."""
    images, labels = _batch()
    model = unet.UNet(convert.from_jax_params(params), torch.float32, trainable=True)
    with pytest.MonkeyPatch.context() as mp:
        if old:
            mp.setattr(k4.ConvStage, "apply", staticmethod(
                lambda x, w, b, s, t, padding, dt: k4.conv_stage_cudnn(x, w, b, s, t, padding,
                                                                       dt)))
        if record is not None:
            real = k4.conv_stage

            def recorded(x, w, b, s=None, t=None, padding=(1, 1), out_dtype=torch.bfloat16,
                         z=None):
                y = real(x, w, b, s, t, padding, out_dtype, z)
                record.append((x.detach().clone(), w.detach().clone(), b.detach().clone(),
                               None if s is None else s.detach().clone(),
                               None if t is None else t.detach().clone(), tuple(padding),
                               out_dtype, y.detach().clone()))
                return y

            mp.setattr(k4, "conv_stage", recorded)
        logits = model.logits(torch.from_numpy(images), torch.bfloat16)
        y = torch.from_numpy(labels)
        loss = 0.5 * cross_entropy_loss(logits, y) + 0.5 * dice_loss(logits, y)
        loss.backward()
    grads = convert.to_jax_params(model.tree({k: p.grad for k, p in model.named_parameters()}))
    return float(loss.detach()), logits.detach().numpy(), dict(_leaves(grads))


def _grad_gate(got, want):
    """(the largest share of a bf16-valued leaf's elements more than one
    bf16 step from JAX's, the largest |difference| of a float32 leaf over
    its largest |gradient|)."""
    far, rel = 0.0, 0.0
    for path, w in want.items():
        g = got[path]
        assert np.isfinite(g).all() and np.abs(g).max() > 0, f"{path}: {g}"
        if path[-1] == "w" or "bn_pre" in path:  # bf16 cotangents in both packages
            steps = k4.bf16_steps(torch.from_numpy(g).to(torch.bfloat16),
                                  torch.from_numpy(w).to(torch.bfloat16))
            far = max(far, float((steps > 1).float().mean()))
        else:
            rel = max(rel, float(np.abs(g - w).max() / np.abs(w).max()))
    return far, rel


def test_once_rounding_stencils_equal_pallas_interpret(jax_runs):
    """The test-only JAX stencils equal the Pallas kernels (interpret mode)
    bit for bit on every pooling and upsampling input of the bf16
    forward."""
    import jax.numpy as jnp

    from lungmask_tpu.ops.pallas.stencil import avg_pool2_pallas, bilinear_up2_pallas

    seen = jax_runs["stencil_inputs"]
    assert len(seen["pool"]) == DEPTH - 1 and len(seen["up"]) == DEPTH - 1
    for name, once, pallas in (("pool", _once_pool, avg_pool2_pallas),
                               ("up", _once_up, bilinear_up2_pallas)):
        for x in seen[name]:
            xb = jnp.asarray(x).astype(jnp.bfloat16)
            got = np.asarray(once(xb).astype(jnp.float32))
            want = np.asarray(pallas(xb, interpret=True).astype(jnp.float32))
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {x.shape}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_train_forward_equals_jax(jax_runs, variant):
    """Under autograd every bf16 stage is K4's Function, each within K4's
    gate of JAX's stage on the same inputs, and the logits within 1e-5 of
    JAX's largest; the stages before K4 miss that bound."""
    import jax.numpy as jnp
    from jax import lax

    from lungmask_tpu.models import unet as junet

    run = jax_runs[variant]
    record = []
    _, logits, _ = _port_step(run["params"], record=record)
    assert len(record) == {"plain": 12, "residual": 17, "upconv": 10}[variant]
    for x, w, b, s, t, padding, out_dtype, y in record:
        whwio = jnp.asarray(w.float().permute(1, 2, 3, 0).numpy()).astype(jnp.bfloat16)
        z = junet._conv_acc32(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), whwio,
                              [(p, p) for p in padding], lax.Precision.DEFAULT)
        z = z + jnp.asarray(b.numpy())
        if s is not None:
            z = junet._affine(jnp.maximum(z, 0.0), {"scale": jnp.asarray(s.numpy()),
                                                    "bias": jnp.asarray(t.numpy())})
        want = torch.from_numpy(np.asarray(z)).to(out_dtype)
        what = f"{tuple(x.shape)} -> {tuple(y.shape)} {out_dtype}"
        if out_dtype == torch.float32:
            assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max()), what
            continue
        a = k4.agreement(y, want, k4.rounding_scale(x, w, b, s, t, padding))
        assert a["differing"] <= MAX_DIFFERING and a["worst"] <= k4.SCALE_RTOL, (what, a)
    scale = np.abs(run["logits"]).max()
    assert np.abs(logits - run["logits"]).max() <= LOGIT_RTOL * scale
    _, old, _ = _port_step(run["params"], old=True)
    assert np.abs(old - run["logits"]).max() > LOGIT_RTOL * scale


@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_gradients_equal_jax(jax_runs, variant):
    """One bf16 step's loss and gradients against ``jax.grad`` by the
    module docstring's gate, which the stages before K4 fail."""
    run = jax_runs[variant]
    loss, _, got = _port_step(run["params"])
    assert sorted(got) == sorted(run["grads"])
    assert loss == pytest.approx(run["loss"], rel=1e-5)
    far, rel = _grad_gate(got, run["grads"])
    assert far <= GRAD_FAR_SHARE and rel <= GRAD_F32_RTOL, (far, rel)
    _, _, old = _port_step(run["params"], old=True)
    far_old, rel_old = _grad_gate(old, run["grads"])
    assert far_old > GRAD_FAR_SHARE or rel_old > GRAD_F32_RTOL, (far_old, rel_old)


@pytest.mark.parametrize("k,padding", [(3, (1, 1)), (3, (0, 1)), (1, (0, 0))])
def test_z_output_equals_plain(k, padding):
    """The wrapper's ``z`` is the plain version's: ``acc + b`` in float32,
    the accumulator of the float32 convolution of the bf16 values; the
    bias-only modes take no ``z``."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.normal(size=(2, 9, 11, 16)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(8, k, k, 16)).astype(np.float32) * 0.2)
    w = w.to(torch.bfloat16)
    b, s, t = (torch.from_numpy(rng.normal(size=8).astype(np.float32)) for _ in range(3))
    ho, wo = 9 + 2 * padding[0] - k + 1, 11 + 2 * padding[1] - k + 1
    z, zr = torch.full((2, ho, wo, 8), float("nan")), torch.empty(2, ho, wo, 8)
    y = k4.conv_stage(x, w, b, s, t, padding, z=z)
    assert torch.equal(y, k4.conv_stage_reference(x, w, b, s, t, padding, z=zr))
    acc = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2),
                                     w.float().permute(0, 3, 1, 2), padding=padding)
    assert torch.equal(z, zr) and torch.equal(z, (acc + b.view(1, -1, 1, 1)).permute(0, 2, 3, 1))
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="pre-activation"):
            k4.conv_stage(x, w, b, padding=padding, out_dtype=dtype, z=z)
    with pytest.raises(ValueError, match="z must be float32"):
        k4.conv_stage(x, w, b, s, t, padding, z=z[:, 1:])
    with pytest.raises(ValueError, match="z must be float32"):
        k4.conv_stage(x, w, b, s, t, padding, z=z.to(torch.bfloat16))


def test_relu_tie_takes_jax_half():
    """A stage whose pre-activation is exactly 0 where its input patch is
    zero (zero bias): the Function's cotangents of b, s, x and the weight
    equal ``jax.grad``'s, which gives half of the cotangent at the tie;
    with ``torch.relu``'s 0 the bias's would differ."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from lungmask_tpu.models import unet as junet

    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    x[:, :5, :5] = 0.0  # z == 0 on the outputs whose 3×3 patch lies inside
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    whwio = torch.from_numpy(rng.normal(size=(3, 3, 4, 6)).astype(np.float32) * 0.3)
    whwio = whwio.to(torch.bfloat16).float().numpy()
    b = np.zeros(6, np.float32)
    s = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    t = rng.uniform(-0.2, 0.2, 6).astype(np.float32)
    g = rng.normal(size=(1, 8, 8, 6)).astype(np.float32)
    g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()

    def jstage(x, w, b, s, t):
        z = junet._conv(x.astype(jnp.bfloat16), w, b, precision=lax.Precision.DEFAULT)
        y = junet._affine(jnp.maximum(z, 0.0), {"scale": s, "bias": t}).astype(jnp.bfloat16)
        return jnp.sum(y.astype(jnp.float32) * g)

    want = jax.grad(jstage, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, whwio, b, s, t)))
    want = [np.asarray(v, np.float32) for v in want]
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(whwio).requires_grad_()
    bt, st, tt = (torch.from_numpy(v).requires_grad_() for v in (b, s, t))
    wk = k4.weight_layout(wt.permute(3, 2, 0, 1))
    y = k4.ConvStage.apply(xt, wk, bt, st, tt, (1, 1), torch.bfloat16)
    z = torch.empty(y.shape)
    k4.conv_stage_reference(xt.detach(), wk.detach(), b=bt.detach(), s=st.detach(),
                            t=tt.detach(), z=z)
    assert int((z == 0).sum()) >= 6 * 9  # ties in every channel
    got = torch.autograd.grad(y.float(), (xt, wt, bt, st, tt), torch.from_numpy(g))
    for name, a, w in zip("xw", got, want):  # bf16 cotangents: float32 sums in other orders
        steps = k4.bf16_steps(a.to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16))
        assert int(steps.max()) <= 1, name
    for name, a, w in zip("bst", got[2:], want[2:]):
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                   err_msg=name)
    relu0 = torch.where(z > 0, torch.from_numpy(g) * st.detach(), torch.zeros(()))
    assert not np.allclose(relu0.sum((0, 1, 2)).numpy(), want[2], rtol=0, atol=1e-4)


def test_unet_relu_takes_jax_half():
    """The U-Net's own ReLUs (the residual block's ``bn_pre`` and the
    float32 epilogue) give half the cotangent at 0, as ``jnp.maximum``."""
    import jax
    import jax.numpy as jnp

    v = np.array([-1.0, 0.0, 0.0, 2.0], np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.maximum(a, 0.0) * jnp.arange(1.0, 5.0)))(
        jnp.asarray(v)))
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.from_numpy(v).to(dtype).requires_grad_()
        (unet._relu(a).float() * torch.arange(1.0, 5.0)).sum().backward()
        np.testing.assert_array_equal(a.grad.float().numpy(), want)
    a = torch.from_numpy(v).view(1, 4, 1, 1).requires_grad_()
    unet._relu_affine(a, torch.ones(4), torch.zeros(4)).sum().backward()
    np.testing.assert_array_equal(a.grad.flatten().numpy(), [0.0, 0.5, 0.5, 1.0])


def _bf16_step(mesh=None, remat=False):
    params = convert.from_jax_params(_params("plain"))
    rec = tp.GradRecorder()
    state = init_train_state(params, rec)
    _, loss = make_train_step(rec, mesh=mesh, compute_dtype=torch.bfloat16, remat=remat)(
        state, *_batch(1, n=4))
    return float(loss), dict(_leaves(convert.to_jax_params(state.model.tree(rec.grads))))


def test_banded_bf16_step_equals_unbanded():
    """A bf16 step over a 1×2 CPU mesh (two bands of 32 rows, K4's Function
    on each padded band, the halo rows' cotangents carried back to their
    bands): the loss bit for bit; every gradient leaf within 2e-2 of its
    largest |gradient| (measured ≤ 7.1e-3): each band's weight cotangent is
    rounded to bf16 before the two are summed, and a halo row's cotangent
    is the bf16 sum of its two bands' dgrads, where the unbanded step
    rounds each once."""
    from lungmask_tpu_torch.parallel import make_mesh

    loss, want = _bf16_step()
    got_loss, got = _bf16_step(mesh=make_mesh(devices=["cpu"] * 2, space=2))
    assert got_loss == loss
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert np.abs(got[path] - w).max() <= 2e-2 * np.abs(w).max(), path


def test_remat_bf16_step_equals_plain():
    """``remat`` recomputes the bf16 forward, K4's Function included, in the
    backward: the loss and every gradient bit for bit."""
    loss, want = _bf16_step()
    got_loss, got = _bf16_step(remat=True)
    assert got_loss == loss
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))


@pytest.mark.cuda
def test_function_on_the_card_matches_plain_stages():
    """On the card: one bf16 step of the narrow U-Net through K4 against
    the same step with K4's plain version in the kernel's place (the same
    backward), by the gradient gate."""
    dev = tp.cuda_device()
    params = convert.from_jax_params(_params("upconv"), dev)
    images, labels = _batch()
    out = []
    for plain in (False, True):
        model = unet.UNet(params, torch.float32, trainable=True)
        with pytest.MonkeyPatch.context() as mp:
            if plain:
                mp.setattr(k4, "conv_stage", k4.conv_stage_reference)
            before = k4.conv_stage.launches if not plain else None
            logits = model.logits(torch.from_numpy(images).to(dev), torch.bfloat16)
            y = torch.from_numpy(labels).to(dev)
            loss = 0.5 * cross_entropy_loss(logits, y) + 0.5 * dice_loss(logits, y)
            loss.backward()
            torch.cuda.synchronize()
            if not plain:
                assert k4.conv_stage.launches - before == 10  # depth 3, upconv
        out.append(dict(_leaves(convert.to_jax_params(model.tree(
            {k: p.grad.cpu() for k, p in model.named_parameters()})))))
    far, rel = _grad_gate(*out)
    assert far <= GRAD_FAR_SHARE and rel <= GRAD_F32_RTOL, (far, rel)
