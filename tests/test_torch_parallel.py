"""The port's device mesh (``lungmask_tpu_torch.parallel``) on CPU meshes
(``make_mesh(devices=["cpu"] * n)``, the counterpart of JAX's virtual CPU
devices), against the port's unsharded paths and the JAX package's mesh.

Tolerances:
* class maps, cleaned maps, boxes, stacks and masks: none — bit for bit;
* one float32 train step: the loss within 1e-5 relative and every gradient
  leaf within 1e-5 of that leaf's largest gradient, against the unsharded
  step on the whole batch (the parts' sums meet in another order);
* a short ``fit``: each step's loss within 1e-4 relative (Adam divides by
  the gradient's magnitude, so rounding differences in near-zero gradient
  elements grow after the first step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.models import convert, synthetic
from lungmask_tpu_torch.parallel import (
    ShardedUNetRunner,
    batch_sharding,
    make_mesh,
    make_sharded_argmax,
    make_sharded_postprocess,
    replicate,
    replicated,
    shard_batch,
)
from lungmask_tpu_torch.parallel.mesh import shard_rows, split_rows
from lungmask_tpu_torch.parallel.sharded import make_sharded_volume_argmax, replicate_unet
from lungmask_tpu_torch.runtime.engine import UNetRunner
from lungmask_tpu_torch.train import default_optimizer, fit, init_train_state, make_train_step
from lungmask_tpu_torch.train import cross_entropy_loss, dice_loss
from lungmask_tpu_torch.train.data import SliceDataset
from lungmask_tpu_torch.transforms import preprocess
from lungmask_tpu_torch.transforms.postprocess_device import postprocess_device


def _cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def params():
    return tp.random_params(n_classes=3, wf=2, seed=1)


def test_mesh_shapes_and_errors():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.devices.shape == (4, 1) and mesh.shape == {"data": 4, "space": 1}
    assert mesh.axis_names == ("data", "space")
    assert make_mesh(n_devices=2, devices=["cpu"] * 4).shape["data"] == 2
    assert mesh.data_devices == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="does not match"):
        make_mesh(data=3, devices=["cpu"] * 4)
    grid = make_mesh(space=2, devices=["cpu"] * 4)  # the space axis (item 10b)
    assert grid.shape == {"data": 2, "space": 2} and grid.devices.shape == (2, 2)
    assert grid.space_devices(1) == [torch.device("cpu")] * 2 and len(grid.data_devices) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    assert split_rows(5, 2) == [(0, 3), (3, 5)] and split_rows(2, 4)[-1] == (2, 2)
    x = torch.arange(12.0).view(6, 2)
    parts = shard_batch(_cpu_mesh(2), x)
    assert [tuple(p.shape) for p in parts] == [(3, 2), (3, 2)]
    assert batch_sharding(mesh).split and not replicated(mesh).split
    with pytest.raises(ValueError, match="split evenly"):
        shard_batch(mesh, x)  # 6 over 4
    assert [p.shape[0] for p in shard_rows(mesh, x)] == [2, 2, 1, 1]
    tree = {"a": [np.ones(2, np.float32)], "b": torch.zeros(3)}
    copies = replicate(mesh, tree)
    assert len(copies) == 4 and torch.equal(copies[3]["a"][0], torch.ones(2))


@pytest.mark.parametrize("ndata", [2, 4])
def test_sharded_runner_equals_unsharded_and_jax(params, ndata):
    """10 slices (uneven slabs) through ``ShardedUNetRunner`` equal the
    unsharded ``UNetRunner`` and the JAX package's ``ShardedUNetRunner`` on
    a data-only mesh of as many virtual devices; ``run_numpy`` (packed,
    split download) equals ``run``."""
    from lungmask_tpu.parallel import ShardedUNetRunner as JShardedUNetRunner
    from lungmask_tpu.parallel import make_mesh as jmake_mesh

    x = tp.blocky_slices(10, 64, 64, seed=3)[..., 0]
    ref = UNetRunner(params, 3, batch_size=4, compute_dtype=torch.float32).run(
        torch.from_numpy(x)).numpy()
    runner = ShardedUNetRunner(params, 3, mesh=_cpu_mesh(ndata), batch_size=4,
                               compute_dtype=torch.float32)
    slabs = runner.run(torch.from_numpy(x))
    assert [s.shape[0] for s in slabs] == [b - a for a, b in split_rows(10, ndata)]
    got = torch.cat(slabs).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(runner.run_numpy(x), ref)
    assert len(np.unique(ref)) >= 2
    jax_runner = JShardedUNetRunner(params, 3, mesh=jmake_mesh(n_devices=ndata), batch_size=4,
                                    compute_dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(jax_runner.run(x)), ref)


def test_sharded_argmax_and_volume_argmax(params):
    mesh = _cpu_mesh(2)
    models = replicate_unet(mesh, params, torch.float32)
    assert models[0] is models[1]  # one device named twice holds one copy
    x = tp.blocky_slices(4, 48, 48, seed=4)
    ref = UNetRunner(params, 3, compute_dtype=torch.float32).run(torch.from_numpy(x[..., 0]))
    parts = make_sharded_argmax(mesh)(models, torch.from_numpy(x))
    assert torch.equal(torch.cat(parts), ref)
    chunks = torch.from_numpy(x[..., 0]).view(2, 2, 48, 48)
    packed = make_sharded_volume_argmax(mesh, bits=4)(models, chunks)
    assert [tuple(p.shape) for p in packed] == [(2, 48, 24)] * 2
    dense = make_sharded_volume_argmax(mesh)(models, chunks)
    assert torch.equal(torch.cat(dense), ref)


@pytest.mark.parametrize("bits", [8, 2])
def test_volume_argmax_packed_keyword(params, bits):
    """``packed=True``, the JAX package's legacy spelling of ``bits=4``,
    gives ``bits=4``'s bytes where ``bits`` is left at 8, and leaves an
    explicit ``bits=2`` alone (``packed and bits == 8``)."""
    mesh = _cpu_mesh(2)
    models = replicate_unet(mesh, params, torch.float32)
    chunks = torch.from_numpy(tp.blocky_slices(4, 48, 48, seed=4)[..., 0]).view(2, 2, 48, 48)
    got = make_sharded_volume_argmax(mesh, packed=True, bits=bits)(models, chunks)
    want = make_sharded_volume_argmax(mesh, bits=4 if bits == 8 else bits)(models, chunks)
    assert [tuple(p.shape) for p in got] == [(2, 48, 48 * (4 if bits == 8 else bits) // 8)] * 2
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _crafted_volume():
    """Components, holes and a three-way area tie across slab boundaries
    (at 8 for two slabs; 4, 8, 12 for four; 6, 11 for three)."""
    vol = np.zeros((16, 24, 24), np.uint8)
    vol[2:14, 2:10, 2:10] = 1  # crosses every boundary
    vol[6:10, 4:8, 4:8] = 0  # its hole, across 8: filled
    vol[0, 20:22, 20:22] = 1  # a satellite: removed
    vol[0:4, 12:15, 2:5] = 2  # class 2: three components of 36 voxels;
    vol[6:10, 12:15, 6:9] = 2  # the second straddles 8,
    vol[12:16, 12:15, 10:13] = 2  # the last (raster-last) wins the tie
    vol[1:15, 16:24, 14:24] = 3  # class 3 touches the border at y, x = 23;
    vol[3:6, 18:21, 16:19] = 0  # a cavity below 8, whose tube
    vol[5:12, 19, 17] = 0  # runs past 8
    vol[11, 19:24, 17] = 0  # to the border: not a hole
    vol[7:9, 21:23, 20:22] = 0  # a hole across 8: filled
    return vol


@pytest.mark.parametrize("ndata", [2, 3, 4])
@pytest.mark.parametrize("depth", [16, 15])
def test_sharded_postprocess_equals_postprocess_device(ndata, depth):
    vol = _crafted_volume()[:depth]
    single = postprocess_device(torch.from_numpy(vol), 4).numpy()
    if depth == 16:
        assert single[8, 5, 5] == 1 and single[0, 21, 21] == 0  # hole filled, satellite gone
        assert single[13, 13, 11] == 2 and single[1, 13, 3] == 0 and single[7, 13, 7] == 0
        assert single[4, 19, 17] == 0 and single[7, 21, 20] == 3  # tunnel kept open, hole filled
    mesh = _cpu_mesh(ndata)
    step = make_sharded_postprocess(mesh, 4)
    got = step(shard_rows(mesh, torch.from_numpy(vol)))
    np.testing.assert_array_equal(torch.cat(got).numpy(), single)


def test_sharded_postprocess_equals_jax_on_random_maps():
    """Random class maps (many components across every boundary) against
    the port's and the JAX package's single-device cleanup."""
    from lungmask_tpu.transforms.postprocess_device import postprocess_device as jpd

    for seed, ndata in ((0, 2), (1, 3), (2, 4)):
        rng = np.random.default_rng(seed)
        vol = ((rng.random((12, 14, 16)) < 0.45) * rng.integers(1, 4, (12, 14, 16))).astype(np.uint8)
        want = np.asarray(jpd(jnp.asarray(vol), 4))
        np.testing.assert_array_equal(postprocess_device(torch.from_numpy(vol), 4).numpy(), want)
        mesh = _cpu_mesh(ndata)
        got = make_sharded_postprocess(mesh, 4)(shard_rows(mesh, torch.from_numpy(vol)))
        np.testing.assert_array_equal(torch.cat(got).numpy(), want, err_msg=f"seed {seed}")
        whole = make_sharded_postprocess(mesh, 4)(torch.from_numpy(vol[:-1]))  # split there
        np.testing.assert_array_equal(torch.cat(whole).numpy(), jpd(jnp.asarray(vol[:-1]), 4))


@pytest.mark.parametrize("ndata", [2, 4])
def test_preprocess_sharded_equals_preprocess(ndata):
    vol = synthetic.lung_phantom(5, size=64)
    want, want_boxes = preprocess.preprocess(vol, device="cpu")
    slabs, boxes = preprocess.preprocess_sharded(vol, _cpu_mesh(ndata))
    assert [s.shape[0] for s in slabs] == [b - a for a, b in split_rows(5, ndata)]
    np.testing.assert_array_equal(boxes, want_boxes)
    assert torch.equal(torch.cat(slabs), want)
    big = synthetic.lung_phantom(3, size=160)  # ≥ 128²: the upzoom box branch
    slabs, boxes = preprocess.preprocess_sharded(big, _cpu_mesh(2), compute_dtype=torch.bfloat16)
    want, want_boxes = preprocess.preprocess(big, compute_dtype=torch.bfloat16, device="cpu")
    np.testing.assert_array_equal(boxes, want_boxes)
    assert torch.equal(torch.cat(slabs), want)
    np.testing.assert_array_equal(preprocess.make_sharded_boxes_fn(_cpu_mesh(2))(big), want_boxes)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("w")
    paths = {}
    for name, p in (("single", synthetic.laterality_params(wf=2)),
                    ("base", synthetic.laterality_params(n_classes=6, wf=2)),
                    ("fill", synthetic.threshold_params(wf=2))):
        paths[name] = str(d / f"{name}.npz")
        convert.save_npz(paths[name], p)
    return paths


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("post", ["exact", "device"])
def test_inferer_with_mesh_equals_unsharded(weights, fused, post):
    """``LMInferer(mesh=)`` (sharded preprocessing by default, and hybrid
    when asked) equals the unsharded inferer with the same preprocessing,
    single model and fused, exact and device postprocessing; 5 slices over
    a two-way mesh (slabs of 3 and 2)."""
    vol = synthetic.lung_phantom(5, size=64)
    kw = dict(modelpath=weights["base" if fused else "single"], tqdm_disable=True,
              postprocessing_mode=post)
    if fused:
        kw.update(fillmodel="R231", fillmodel_path=weights["fill"])
    mesh = _cpu_mesh(2)
    sharded = LMInferer(mesh=mesh, **kw)
    assert sharded.preprocessing == "sharded" and sharded.device.type == "cpu"
    got = sharded.apply(vol)
    want = LMInferer(device="cpu", preprocessing="device", **kw).apply(vol)
    np.testing.assert_array_equal(got, want)
    assert got.any()
    hybrid = LMInferer(mesh=mesh, preprocessing="hybrid", batch_size=3, **kw)
    assert hybrid.model.batch_size == 4  # rounded up to the data axis
    np.testing.assert_array_equal(hybrid.apply(vol), LMInferer(device="cpu", **kw).apply(vol))


def test_inferer_mesh_device_postprocess_splits_a_whole_map(weights):
    """A whole class map handed to the mesh's cleanup is split into uneven
    slabs (5 slices: 3 and 2); the result equals the single-device
    cleanup."""
    vol = synthetic.lung_phantom(5, size=64)
    inferer = LMInferer(modelpath=weights["single"], tqdm_disable=True, mesh=_cpu_mesh(2),
                        postprocessing_mode="device")
    pred = torch.cat(inferer.forward_preprocessed(inferer.preprocess_image(vol)))
    got = inferer._pipeline._device_postprocess(pred.numpy(), 3)
    np.testing.assert_array_equal(got, postprocess_device(pred, 3).numpy())


def _batch():
    """4 slices whose halves differ in which classes they hold, so each
    half's Dice differs from the whole batch's."""
    images = tp.blocky_slices(4, 48, 48, seed=6)
    labels = np.zeros((4, 48, 48), np.int32)
    labels[:2, 10:30, 8:40] = 1
    labels[2:, 16:40, 4:20] = 2
    labels[3, 30:44, 30:44] = 1
    return images, labels


def _grads(params, images, labels, mesh=None):
    rec = tp.GradRecorder()
    state = init_train_state(convert.from_jax_params(params), rec)
    _, loss = make_train_step(rec, mesh=mesh, compute_dtype=torch.float32)(state, images, labels)
    return float(loss), rec.grads


@pytest.mark.parametrize("ndata", [2, 4])
def test_sharded_train_step_equals_unsharded(params, ndata):
    """One float32 step over a data mesh: the loss and every gradient equal
    the unsharded step's on the whole batch. The Dice trap: averaging the
    parts' losses gives gradients far outside the tolerance, so this test
    fails for a step that does so."""
    images, labels = _batch()
    want_loss, want = _grads(params, images, labels)
    got_loss, got = _grads(params, images, labels, _cpu_mesh(ndata))
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        scale = float(want[k].abs().max())
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=k)

    # The averaged parts' losses, for contrast.
    model = init_train_state(convert.from_jax_params(params), tp.GradRecorder()).model
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    losses = []
    for part in range(ndata):
        sl = slice(part * 4 // ndata, (part + 1) * 4 // ndata)
        logits = model.logits(x[sl], torch.float32)
        losses.append(0.5 * cross_entropy_loss(logits, y[sl]) + 0.5 * dice_loss(logits, y[sl]))
    torch.stack(losses).mean().backward()
    worst = max(float((p.grad - want[k]).abs().max() / want[k].abs().max())
                for k, p in model.named_parameters())
    assert worst > 1e-3


def test_fit_with_mesh_tracks_unsharded_fit(params):
    def pair(seed):
        vol = synthetic.lung_phantom(4, size=64)
        return vol, (vol < -500).astype(np.uint8) * (1 + seed % 2)

    ds = SliceDataset([pair(0), pair(1)], resolution=(48, 48), device="cpu")
    kw = dict(epochs=1, batch_size=4, optimizer=default_optimizer(2), compute_dtype=torch.float32,
              log_every=1, seed=3)
    tree = convert.from_jax_params(params)
    got = fit(tree, ds, mesh=_cpu_mesh(2), **kw)
    want = fit(tree, ds, device="cpu", **kw)
    losses = [[h["loss"] for h in r.history if "loss" in h] for r in (got, want)]
    assert len(losses[0]) == 2 and got.state.step == 2
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
