"""Fine-tuning in the port (``lungmask_tpu_torch.train``) against the JAX
package's ``lungmask_tpu.train``, on a narrow U-Net (depth 3, wf 2) at 64²
with batch 2, on the CPU.

Tolerances:
* the losses of one batch: 1e-6 absolute (float32 reductions in another
  order);
* one float32 step's loss: 1e-5 relative; every gradient leaf within 1e-4
  of that leaf's largest gradient, and no leaf all zero (a stencil without
  a backward would leave the levels below it at zero);
* bf16 against float32 in the port: the loss within 2e-2 relative, one SGD
  step (lr 1e-2) of a deep and a shallow kernel within 5e-4 — the bounds of
  the JAX package's ``test_train_step_bfloat16``;
* ``default_optimizer`` against optax's on shared gradients: each update
  within 1e-6 of its leaf's largest update (float32 arithmetic of the same
  formulas in another order; an element whose first moment nearly cancels
  has a small update, so its own relative error is larger);
* resume on the CPU: none, the losses are bit for bit;
* a JAX train state resumed in the port: the parameters after one more step
  within 1e-5 of JAX's.
"""

import os

import numpy as np
import pytest
import torch

import torch_parity as tp
from lungmask_tpu_torch.io import image, loader
from lungmask_tpu_torch.models import convert, unet
from lungmask_tpu_torch.ops.kernels import stencil
from lungmask_tpu_torch.train import (
    Augmenter,
    cross_entropy_loss,
    default_optimizer,
    dice_loss,
    fit,
    init_train_state,
    make_train_step,
)
from lungmask_tpu_torch.train import checkpoint as ckpt
from lungmask_tpu_torch.train.data import SliceDataset, slices_from_pair
from lungmask_tpu_torch.train.optim import apply_updates

DEPTH, WF, CLASSES = 3, 2, 3


def _pair(seed, n=3, hw=64):
    """A body with one lung (label 1) per slice: the JAX training tests'."""
    rng = np.random.default_rng(seed)
    vol = np.full((n, hw, hw), -1000, dtype=np.int16)
    mask = np.zeros((n, hw, hw), dtype=np.uint8)
    yy, xx = np.mgrid[0:hw, 0:hw]
    body = ((yy - hw / 2) / (hw * 0.35)) ** 2 + ((xx - hw / 2) / (hw * 0.3)) ** 2 < 1
    lung = ((yy - hw / 2) / (hw * 0.15)) ** 2 + ((xx - hw / 2) / (hw * 0.12)) ** 2 < 1
    for i in range(n):
        vol[i][body] = 40 + rng.integers(-30, 30, size=int(body.sum()))
        vol[i][lung] = -850
        mask[i][lung] = 1
    return vol, mask


def _jax_params(seed=0, n_classes=CLASSES):
    """JAX-layout numpy weights: JAX's init (depth 3, wf 2), affines drawn
    around identity from a numpy seed so they matter."""
    import jax

    from lungmask_tpu.models import unet as junet

    params = jax.tree_util.tree_map(
        np.asarray, junet.init_params(jax.random.PRNGKey(seed), n_classes, depth=DEPTH, wf=WF)
    )
    rng = np.random.default_rng(seed)

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
    images = tp.blocky_slices(n, 64, 64, seed)
    labels = rng.integers(0, CLASSES, (n, 64, 64)).astype(np.int32)
    labels[:, 20:44, 16:48] = 1
    return images, labels


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _port_grads(model):
    return convert.to_jax_params(model.tree({k: p.grad for k, p in model.named_parameters()}))


def test_losses_equal_jax():
    import jax.numpy as jnp

    from lungmask_tpu.train import trainer as jtrainer

    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (2, 16, 16, CLASSES)).astype(np.float32)
    labels = rng.integers(0, CLASSES, (2, 16, 16)).astype(np.int32)
    lt, lb = torch.from_numpy(logits), torch.from_numpy(labels)
    for port_fn, jax_fn in ((cross_entropy_loss, jtrainer.cross_entropy_loss),
                            (dice_loss, jtrainer.dice_loss)):
        got = float(port_fn(lt, lb))
        want = float(jax_fn(jnp.asarray(logits), jnp.asarray(labels)))
        assert abs(got - want) <= 1e-6, (port_fn.__name__, got, want)


def test_f32_gradients_equal_jax():
    import jax
    import jax.numpy as jnp

    from lungmask_tpu.models import unet as junet
    from lungmask_tpu.train import trainer as jtrainer

    params = _jax_params()
    images, labels = _batch()

    def jloss(p, x, y):
        logits = junet.unet_logits(p, x, compute_dtype=jnp.float32)
        return 0.5 * jtrainer.cross_entropy_loss(logits, y) + 0.5 * jtrainer.dice_loss(logits, y)

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(params, jnp.asarray(images),
                                                     jnp.asarray(labels))
    model = unet.UNet(convert.from_jax_params(params), torch.float32, trainable=True)
    logits = model.logits(torch.from_numpy(images), torch.float32)
    y = torch.from_numpy(labels)
    loss = 0.5 * cross_entropy_loss(logits, y) + 0.5 * dice_loss(logits, y)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    got = dict(_leaves(_port_grads(model)))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert sorted(got) == sorted(want) and len(got) == 18 * DEPTH - 8
    for path, g in got.items():
        w = want[path]
        scale = np.abs(w).max()
        assert scale > 0 and np.abs(g).max() > 0, f"{path}: an all-zero gradient"
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale, err_msg=str(path))


def test_bf16_step_tracks_f32():
    images, labels = _batch(2)
    params = convert.from_jax_params(_jax_params(1))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = unet.UNet(params, torch.float32, trainable=True)
        logits = model.logits(torch.from_numpy(images), dtype)
        y = torch.from_numpy(labels)
        loss = 0.5 * cross_entropy_loss(logits, y) + 0.5 * dice_loss(logits, y)
        loss.backward()
        assert torch.isfinite(loss)
        out[dtype] = (float(loss.detach()), _port_grads(model))
    assert out[torch.bfloat16][0] == pytest.approx(out[torch.float32][0], rel=2e-2)
    jax_params = convert.to_jax_params(params)
    for path in (("down", 0, "conv1", "w"), ("last", "w")):
        p, g16, g32 = jax_params, out[torch.bfloat16][1], out[torch.float32][1]
        for k in path:
            p, g16, g32 = p[k], g16[k], g32[k]
        np.testing.assert_allclose(p - 1e-2 * g16, p - 1e-2 * g32, rtol=0, atol=5e-4)


def test_remat_step_equals_plain_step():
    """``remat`` recomputes the forward in the backward: the same loss and
    the same updated weights, bit for bit on the CPU."""
    images, labels = _batch(3)
    out = []
    for remat in (False, True):
        optimizer = default_optimizer(4)
        state = init_train_state(convert.from_jax_params(_jax_params(2)), optimizer)
        launches = stencil.avg_pool2.launches
        state, loss = make_train_step(optimizer, compute_dtype=torch.float32, remat=remat)(
            state, images, labels)
        out.append((float(loss), convert.to_jax_params(state.params)))
    assert out[0][0] == out[1][0]
    for (path, a), (_, b) in zip(_leaves(out[0][1]), _leaves(out[1][1])):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert stencil.avg_pool2.launches == launches  # the CPU takes the plain versions


def test_default_optimizer_equals_optax():
    """12 steps across warmup (3 steps) and cosine decay on the same seeded
    gradients; step 5's gradient is above the clip norm."""
    import jax
    import jax.numpy as jnp

    from lungmask_tpu.train.loop import default_optimizer as jax_default_optimizer

    rng = np.random.default_rng(3)
    shapes = {"a": (3, 3, 2, 4), "b": (4,), "c": (5, 7)}
    params0 = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    opt, jopt = default_optimizer(12, warmup_frac=0.25), jax_default_optimizer(12, warmup_frac=0.25)
    params = {k: torch.from_numpy(v.copy()) for k, v in params0.items()}
    jparams = {k: jnp.asarray(v) for k, v in params0.items()}
    state, jstate = opt.init(params), jopt.init(jparams)
    for step in range(12):
        scale = 2.0 if step == 5 else 0.05
        grads = {k: (scale * rng.normal(0, 1, s)).astype(np.float32) for k, s in shapes.items()}
        norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values()))
        assert (norm > 1.0) == (step == 5)
        updates, state = opt.update({k: torch.from_numpy(g) for k, g in grads.items()},
                                    state, params)
        jupdates, jstate = jopt.update({k: jnp.asarray(g) for k, g in grads.items()},
                                       jstate, jparams)
        for k in shapes:
            want = np.asarray(jupdates[k])
            np.testing.assert_allclose(updates[k].numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"step {step} leaf {k}")
        apply_updates(params, updates)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, jupdates)
    assert state.count == state.schedule_count == 12


def _dataset():
    return SliceDataset([_pair(0, n=4)], resolution=(64, 64), device="cpu")


def _fresh_state(optimizer):
    params = unet.init_params(2, depth=DEPTH, wf=WF, generator=torch.Generator().manual_seed(0))
    return init_train_state(params, optimizer)


def test_checkpoint_resume_is_exact(tmp_path):
    """Save mid-training, resume into a fresh state, continue: the losses
    equal an uninterrupted run's bit for bit."""
    optimizer = default_optimizer(8, peak_lr=3e-3)
    step = make_train_step(optimizer, compute_dtype=torch.float32)
    batches = list(_dataset().batches(batch_size=2, epochs=4, seed=1))
    state = _fresh_state(optimizer)
    losses_ref = []
    for im, lb in batches:
        state, loss = step(state, im, lb)
        losses_ref.append(float(loss))

    state = _fresh_state(optimizer)
    mid = len(batches) // 2
    for im, lb in batches[:mid]:
        state, _ = step(state, im, lb)
    path = str(tmp_path / "ckpt")  # no .npz: normalized on save and load
    ckpt.save_train_state(path, state, meta={"note": "mid"})
    restored, meta = ckpt.load_train_state(path, _fresh_state(optimizer))
    assert meta == {"note": "mid"} and restored.step == mid
    assert restored.opt_state.count == restored.opt_state.schedule_count == mid
    losses = []
    for im, lb in batches[mid:]:
        restored, loss = step(restored, im, lb)
        losses.append(float(loss))
    assert losses == losses_ref[mid:]


def test_checkpoint_mismatch_raises(tmp_path):
    optimizer = default_optimizer(4)
    path = str(tmp_path / "c.npz")
    ckpt.save_train_state(path, _fresh_state(optimizer))
    deeper = unet.init_params(2, depth=DEPTH + 1, wf=WF, generator=torch.Generator())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_train_state(path, init_train_state(deeper, optimizer))


def test_jax_train_state_resumes_in_the_port(tmp_path):
    """JAX takes 2 steps of ``default_optimizer`` and saves; both packages
    take step 3 on the same batch. The port's own file reads back in JAX."""
    import jax
    import jax.numpy as jnp

    from lungmask_tpu.train import trainer as jtrainer
    from lungmask_tpu.train.checkpoint import load_train_state as jload
    from lungmask_tpu.train.checkpoint import save_train_state as jsave
    from lungmask_tpu.train.loop import default_optimizer as jax_default_optimizer

    params = _jax_params(2, n_classes=2)
    batches = list(_dataset().batches(batch_size=2, epochs=2, seed=4))[:3]
    jopt = jax_default_optimizer(10, peak_lr=1e-3)
    jstep = jtrainer.make_train_step(jopt, compute_dtype=jnp.float32)
    jstate = jtrainer.init_train_state(params, jopt)
    for im, lb in batches[:2]:
        jstate, _ = jstep(jstate, jnp.asarray(im), jnp.asarray(lb))
    path = str(tmp_path / "jax_state.npz")
    jsave(path, jstate, meta={"from": "jax"})

    state, meta = ckpt.load_jax_train_state(path, device="cpu")
    assert meta == {"from": "jax"} and state.step == 2 and state.opt_state.count == 2
    step = make_train_step(default_optimizer(10, peak_lr=1e-3), compute_dtype=torch.float32)
    state, loss = step(state, *batches[2])
    jstate, jloss = jstep(jstate, jnp.asarray(batches[2][0]), jnp.asarray(batches[2][1]))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    got = dict(_leaves(convert.to_jax_params(state.params)))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jstate.params)))
    assert sorted(got) == sorted(want)
    for path_, g in got.items():
        np.testing.assert_allclose(g, want[path_], rtol=0, atol=1e-5, err_msg=str(path_))

    mine = str(tmp_path / "port_state.npz")
    ckpt.save_train_state(mine, state)
    back, _ = jload(mine, jstate)
    assert int(back.step) == 3
    for a, b in zip(jax.tree_util.tree_leaves(back.params),
                    jax.tree_util.tree_leaves(convert.to_jax_params(state.params))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_fit_improves_loss_and_checkpoints(tmp_path):
    ds = SliceDataset([_pair(0, n=4), _pair(1, n=4)], resolution=(64, 64), device="cpu")
    eval_pairs = slices_from_pair(*_pair(2, n=2), resolution=(64, 64), device="cpu")
    params = unet.init_params(2, depth=DEPTH, wf=WF, generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "state.npz")
    launches = stencil.avg_pool2_bwd.launches
    res = fit(params, ds, epochs=6, batch_size=2, optimizer=default_optimizer(24, peak_lr=1e-2),
              augment=Augmenter(flip_p=0.5, shift_scale_p=0.0, intensity_p=0.5, noise_p=0.5),
              eval_pairs=eval_pairs, eval_every=12, checkpoint_path=path, checkpoint_every=12,
              compute_dtype=torch.float32, seed=1, log_every=1, device="cpu")
    losses = [h["loss"] for h in res.history if "loss" in h]
    assert len(losses) == 24 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    dice = [h["eval_macro_dice"] for h in res.history if "eval_macro_dice" in h]
    assert len(dice) == 2 and res.best_dice == max(dice)
    assert stencil.avg_pool2_bwd.launches == launches  # the CPU takes the plain adjoints
    restored, _ = ckpt.load_train_state(path, init_train_state(params, default_optimizer(24)))
    assert restored.step == res.state.step == 24
    from lungmask_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="split evenly"):  # the sharded loop's batch
        fit(params, ds, batch_size=3, mesh=make_mesh(devices=["cpu"] * 2))
    # The mesh's space axis: one step over two bands, the unsharded step's loss.
    images, labels = next(ds.batches(2, seed=0))
    losses = []
    for mesh in (None, make_mesh(devices=["cpu"] * 2, space=2)):
        step = make_train_step(default_optimizer(4), mesh=mesh, compute_dtype=torch.float32)
        _, loss = step(init_train_state(params, default_optimizer(4)), images, labels)
        losses.append(float(loss))
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)


def test_finetune_cli_weights_load_in_jax(tmp_path):
    import lungmask_tpu
    from lungmask_tpu_torch.train import finetune

    data = tmp_path / "data"
    data.mkdir()
    for i in range(3):
        vol, mask = _pair(10 + i, n=4)
        loader.write_image(image.MedicalImage(vol), str(data / f"case{i}.nii.gz"))
        loader.write_image(image.MedicalImage(mask), str(data / f"case{i}_mask.nii.gz"))
    start = str(tmp_path / "start.npz")
    init = unet.init_params(2, depth=DEPTH, wf=WF, generator=torch.Generator().manual_seed(3))
    convert.save_npz(start, convert.to_jax_params(init))
    out = str(tmp_path / "tuned.npz")
    finetune.main([str(data), out, "--epochs", "2", "--model", start, "--resolution", "64",
                   "--cpu"])
    assert os.path.exists(out) and os.path.exists(str(tmp_path / "tuned-trainstate.npz"))
    tuned, meta = convert.load_npz(out)
    assert meta["finetuned_from"] == start
    assert not np.array_equal(tuned["last"]["w"], convert.to_jax_params(init)["last"]["w"])
    vol, _ = _pair(20, n=2)
    mask = lungmask_tpu.LMInferer(modelpath=out, tqdm_disable=True, precision="float32",
                                  volume_postprocessing=False).apply(vol)
    assert mask.shape == vol.shape and mask.dtype == np.uint8
