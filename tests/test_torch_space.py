"""The mesh's ``space`` axis in the port (``parallel/halo.py`` and the banded
paths of ``parallel/``, ``inferer`` and ``train``) on CPU meshes
(``make_mesh(devices=["cpu"] * n, space=s)``), against the port's unbanded
paths and the JAX package's (4, 2) mesh ``make_mesh(n_devices=8,
space=2)`` on the 8 virtual CPU devices of ``tests/conftest.py``; wf=2,
depth 5, float32.

Tolerances:
* class maps, cleaned maps, masks and the stencils' plain versions on
  bands: none — bit for bit;
* banded float32 logits: within 1e-5 of the largest |logit| of the
  unbanded ones;
* one float32 train step against JAX's step on its (4, 2) mesh: the loss
  within 1e-5 relative, every gradient leaf within 1e-4 of that leaf's
  largest gradient (the bands' sums meet in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp
from lungmask_tpu.models import convert as jconvert
from lungmask_tpu.models import unet as junet
from lungmask_tpu.parallel import ShardedUNetRunner as JShardedUNetRunner
from lungmask_tpu.parallel import make_mesh as jmake_mesh
from lungmask_tpu.parallel import make_sharded_postprocess as jmake_sharded_postprocess
from lungmask_tpu.transforms.postprocess_device import postprocess_device as jpostprocess_device
from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.models import convert, synthetic, unet
from lungmask_tpu_torch.ops.kernels import stencil
from lungmask_tpu_torch.parallel import ShardedUNetRunner, make_mesh, make_sharded_postprocess
from lungmask_tpu_torch.parallel.halo import Bands
from lungmask_tpu_torch.parallel.mesh import shard_blocks, split_bands
from lungmask_tpu_torch.parallel.sharded import make_sharded_argmax, replicate_unet
from lungmask_tpu_torch.train import default_optimizer, init_train_state, make_train_step
from lungmask_tpu_torch.transforms.postprocess_device import postprocess_device


def _cpu_mesh(data, space=2):
    return make_mesh(devices=["cpu"] * (data * space), space=space)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(n_devices=8, space=2)


def _whole(blocks) -> np.ndarray:
    """A grid of blocks ([data row][band]) joined on the host."""
    return np.concatenate([np.concatenate([b.numpy() for b in row], axis=1) for row in blocks])


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, np.asarray(tree)


# -- the grid and the bands ---------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (1, 2)])
def test_make_mesh_grid_equals_jax(shape):
    """Device i at [i // space, i % space], as JAX lays it out."""
    data, space = shape
    mesh = make_mesh(devices=[f"cpu:{i}" for i in range(data * space)], space=space)
    jmesh = jmake_mesh(n_devices=data * space, space=space)
    assert mesh.shape == {"data": data, "space": space}
    assert mesh.devices.shape == jmesh.devices.shape == shape
    got = [[dev.index for dev in row] for row in mesh.devices]
    assert got == [[dev.id for dev in row] for row in jmesh.devices]
    assert [d.index for d in mesh.space_devices(data - 1)] == got[-1]
    with pytest.raises(ValueError, match="does not match"):
        make_mesh(devices=["cpu"] * 3, space=2)


@pytest.mark.parametrize("h, space, depth, want", [
    (64, 2, 5, [(0, 32), (32, 64)]),
    (256, 2, 5, [(0, 128), (128, 256)]),
    (72, 2, 5, [(0, 32), (32, 72)]),  # not a multiple of 16: the last band takes 8 more
    (48, 2, 5, [(0, 32), (32, 48)]),  # 3 blocks: the first band one more
    (24, 2, 5, [(0, 16), (16, 24)]),
    (8, 2, 5, [(0, 0), (0, 8)]),  # no whole block: the first band empty
    (20, 4, 5, [(0, 16), (16, 16), (16, 16), (16, 20)]),  # empty bands in the middle
    (10, 2, 3, [(0, 4), (4, 10)]),  # depth 3: blocks of 4 rows
])
def test_split_bands(h, space, depth, want):
    got = split_bands(h, space, depth)
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == h
    assert all(b == c for (_, b), (c, _) in zip(got[:-1], got[1:]))
    assert all(a % 2 ** (depth - 1) == 0 for a, _ in got)


def _variant_params(variant):
    """A JAX-layout tree: numpy-seeded weights (plain), or a seeded
    reference state dict (residual, upconv); seeds whose random nets give
    more than one class on the test's input, so that the argmax check
    bites."""
    if variant == "plain":
        return tp.random_params(n_classes=3, wf=2, seed=1)
    residual = variant == "residual"
    sd = synthetic.reference_state_dict(3, depth=5, wf=2, residual=residual,
                                        up_mode="upsample" if residual else "upconv",
                                        seed=4 if residual else 0)
    return jconvert.convert_state_dict(sd)


@pytest.mark.parametrize("variant, h", [("plain", 64), ("residual", 64), ("upconv", 64),
                                        ("plain", 72)])
def test_banded_unet_equals_unbanded_and_jax(jmesh, variant, h):
    """Banded logits (two bands: 32 + 32 rows, or 32 + 40 at H = 72, whose
    U-Net output of 64 rows is centre-cropped) against the unbanded ones;
    the argmax of ``ShardedUNetRunner`` over a (4, 2) mesh equal to the
    unbanded argmax and to JAX's, from its ``ShardedUNetRunner`` on its
    (4, 2) mesh or, at H = 72, its unsharded U-Net."""
    params = _variant_params(variant)
    x = tp.blocky_slices(8, h, 64, seed=3)
    model = unet.UNet(convert.from_jax_params(params), torch.float32)
    with torch.no_grad():
        ref = model.logits(torch.from_numpy(x))
        bands = model.logits(Bands([torch.from_numpy(x[:, a:b]) for a, b in split_bands(h, 2)]))
    got = torch.cat(bands.parts, dim=1)
    assert bands.rows == [32, 32] and got.shape == ref.shape == (8, 64, 64, 3)
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5 * scale)
    want = ref.argmax(-1).to(torch.uint8).numpy()
    assert len(np.unique(want)) >= 2

    runner = ShardedUNetRunner(params, 3, mesh=_cpu_mesh(4), batch_size=8,
                               compute_dtype=torch.float32)
    maps = runner.run(torch.from_numpy(x[..., 0]))
    assert [[tuple(b.shape) for b in row] for row in maps] == [[(2, 32, 64)] * 2] * 4
    np.testing.assert_array_equal(_whole(maps), want)
    np.testing.assert_array_equal(runner.run_numpy(x[..., 0]), want)
    if h == 64:
        jax_runner = JShardedUNetRunner(params, 3, mesh=jmesh, batch_size=8,
                                        compute_dtype=jnp.float32)
        jwant = np.asarray(jax_runner.run(x[..., 0]))
    else:
        jwant = np.asarray(junet.unet_argmax(params, jnp.asarray(x), compute_dtype=jnp.float32))
    np.testing.assert_array_equal(want, jwant)


def test_sharded_argmax_programs_on_bands():
    """``make_sharded_argmax`` and ``make_sharded_volume_argmax`` over a
    (2, 2) mesh: blocks [data][band], equal to the unbanded map; a 24-row
    input leaves the second band without rows after the fourth pooling,
    and its map is empty."""
    from lungmask_tpu_torch.parallel.sharded import make_sharded_volume_argmax

    params = tp.random_params(n_classes=3, wf=2, seed=1)
    mesh = _cpu_mesh(2)
    models = replicate_unet(mesh, params, torch.float32)
    model = unet.UNet(convert.from_jax_params(params), torch.float32)
    for h in (64, 24):
        x = torch.from_numpy(tp.blocky_slices(4, h, 48, seed=4))
        with torch.no_grad():
            want = model.logits(x).argmax(-1).to(torch.uint8).numpy()
        blocks = make_sharded_argmax(mesh)(models, x)
        if h == 24:
            assert [tuple(b.shape) for b in blocks[0]] == [(2, 16, 48), (2, 0, 48)]
        np.testing.assert_array_equal(_whole(blocks), want)
    x = torch.from_numpy(tp.blocky_slices(4, 64, 48, seed=5)[..., 0])
    with torch.no_grad():
        want = model.logits(x.unsqueeze(-1)).argmax(-1).to(torch.uint8).numpy()
    packed = make_sharded_volume_argmax(mesh, bits=4)(models, x.view(2, 2, 64, 48))
    assert [[tuple(b.shape) for b in row] for row in packed] == [[(2, 32, 24)] * 2] * 2
    dense = make_sharded_volume_argmax(mesh)(models, x.view(2, 2, 64, 48))
    np.testing.assert_array_equal(_whole(dense), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 12, 8), (1, 40, 6, 16)])
def test_stencils_on_bands_equal_whole_height(shape, dtype):
    """The plain K3 on each band padded with a neighbour row per inner side,
    its 2 output rows there cropped, equals the whole-height K3's rows bit
    for bit; the plain K3ᵀ of a band's zero-padded output gradient equals,
    on the padded band's rows, K3ᵀ of the whole-height gradient with the
    other bands' rows zeroed; K2 and K2ᵀ on each band equal the whole
    height's rows."""
    n, h, w, c = shape
    rng = np.random.default_rng(h)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((n, 2 * h, 2 * w, c), dtype=np.float32)).to(dtype)
    bounds = split_bands(h, 3, depth=4)  # three bands starting at multiples of 8 rows
    whole = stencil.bilinear_up2_reference(x)
    up = Bands([x[:, a:b] for a, b in bounds]).halo(stencil.bilinear_up2_reference,
                                                    rows=1, zeros=False, crop=2)
    assert torch.equal(torch.cat(up.parts, dim=1), whole)
    pooled = stencil.avg_pool2_reference(x)
    for i, (a, b) in enumerate(bounds):
        lo, hi = max(a - 1, 0), min(b + 1, h)  # the padded band
        gp = torch.zeros((n, 2 * (hi - lo), 2 * w, c), dtype=dtype)
        gp[:, 2 * (a - lo) : 2 * (b - lo)] = g[:, 2 * a : 2 * b]
        masked = torch.zeros_like(g)
        masked[:, 2 * a : 2 * b] = g[:, 2 * a : 2 * b]
        assert torch.equal(stencil.bilinear_up2_bwd_reference(gp),
                           stencil.bilinear_up2_bwd_reference(masked)[:, lo:hi]), i
        assert torch.equal(stencil.avg_pool2_reference(x[:, a:b]), pooled[:, a // 2 : b // 2])
        gq = g[:, : h // 2, : w // 2]
        band_grad = stencil.avg_pool2_bwd_reference(gq[:, a // 2 : b // 2], (n, b - a, w, c))
        assert torch.equal(band_grad, stencil.avg_pool2_bwd_reference(gq, (n, h, w, c))[:, a:b])


# -- the banded cleanup -------------------------------------------------------


def _jax_volume():
    """The volume of ``tests/test_parallel.py::
    test_sharded_postprocess_matches_single_device``."""
    vol = np.zeros((16, 32, 32), dtype=np.uint8)
    vol[2:14, 4:16, 4:16] = 1
    vol[6:10, 8:12, 8:12] = 0
    vol[1, 28:31, 28:31] = 1
    vol[3:13, 18:30, 18:30] = 2
    vol[5:8, 22:26, 22:26] = 0
    vol[15, 1:3, 1:3] = 2
    return vol


def _band_volume():
    """8 × 32 × 24 for a (2, 2) mesh (slabs of 4 slices, bands of 16 rows):
    class 1 — two lines of 10 voxels that touch only across the corner the
    four blocks share ((3, 15, 9) and (4, 16, 10)), their 20 voxels beating
    a block of 18; class 2 — the same across the other diagonal ((3, 16)
    and (4, 15)); class 3 — an area tie of two 12-voxel pieces, one across
    the band edge at slice 6 (raster-last: it wins), one in the second band
    at slice 0; class 1 again — a hollow box across both edges whose cavity
    reaches the band and slab edges inside the volume, never its border."""
    vol = np.zeros((8, 32, 24), dtype=np.uint8)
    vol[3, 15, 0:10] = 1
    vol[4, 16, 10:20] = 1
    vol[0:2, 26:29, 0:3] = 1  # 18 voxels: removed
    vol[3, 16, 0:10] = 2
    vol[4, 15, 10:20] = 2
    vol[0:2, 0:3, 20:23] = 2  # 18 voxels: removed
    vol[6, 13:19, 22:24] = 3  # across the band edge at row 16
    vol[0, 20:26, 22:24] = 3
    return vol


def _hole_volume():
    """A hollow class-1 box across the slab edge (slice 4) and the band
    edge (row 16) of a (2, 2) mesh: its cavity, cut by both edges, touches
    the volume's border nowhere, so it is filled."""
    vol = np.zeros((8, 32, 24), dtype=np.uint8)
    vol[1:7, 10:22, 2:14] = 1
    vol[2:6, 11:21, 3:13] = 0
    vol[0, 30:32, 0:2] = 2
    return vol


@pytest.mark.parametrize("case", ["jax volume", "diagonal corners and ties", "band-edge hole",
                                  "random maps"])
def test_banded_cleanup_equals_jax(jmesh, case):
    """``make_sharded_postprocess`` over a (4, 2), a (2, 2) and a (1, 3)
    mesh (whose third band is empty), from a whole map and from its blocks,
    bit-equal to the port's ``postprocess_device`` and to the JAX
    package's: on its test's volume, its ``make_sharded_postprocess`` on
    its (4, 2) mesh, else its ``postprocess_device``."""
    n_classes = 4
    if case == "jax volume":
        vols, n_classes = [_jax_volume()], 3
    elif case == "diagonal corners and ties":
        vols = [_band_volume()]
    elif case == "band-edge hole":
        vols = [_hole_volume()]
    else:
        rng = np.random.default_rng(7)
        vols = [((rng.random((8, 32, 24)) < p) * rng.integers(1, 4, (8, 32, 24))).astype(np.uint8)
                for p in (0.3, 0.45, 0.6)]  # the crafted volumes' shape: one JAX compile
    for vol in vols:
        if case == "jax volume":  # JAX's own sharded cleanup of its test's volume
            want = np.asarray(jmake_sharded_postprocess(jmesh, 3)(jnp.asarray(vol)))
        else:
            want = np.asarray(jpostprocess_device(jnp.asarray(vol), n_classes))
        np.testing.assert_array_equal(postprocess_device(torch.from_numpy(vol), n_classes).numpy(),
                                      want)
        for mesh in (_cpu_mesh(4), _cpu_mesh(2), _cpu_mesh(1, space=3)):
            step = make_sharded_postprocess(mesh, n_classes)
            np.testing.assert_array_equal(_whole(step(torch.from_numpy(vol))), want)
            blocks = shard_blocks(mesh, torch.from_numpy(vol))
            np.testing.assert_array_equal(_whole(step(blocks)), want)
    if case == "jax volume":
        assert want[8, 10, 10] == 1 and want[1, 29, 29] == 0
    elif case == "diagonal corners and ties":
        assert want[3, 15, 0] == want[4, 16, 19] == 1 and want[0, 26, 0] == 0
        assert want[3, 16, 0] == want[4, 15, 19] == 2 and want[0, 0, 20] == 0
        assert want[6, 13, 22] == 3 and want[0, 20, 22] == 0
    elif case == "band-edge hole":
        assert want[3, 15, 8] == want[4, 16, 8] == 1 and want[0, 30, 0] == 2


# -- the inferer and the train step -------------------------------------------


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
def test_inferer_space_mesh_equals_unsharded_and_jax(weights, jmesh, fused, post):
    """``LMInferer(mesh=)`` over a (4, 2) mesh (5 slices: slabs of 2, 1, 1,
    1, each in two bands of 128 rows), f32, single model and fused, exact
    and device postprocessing: the mask equal to the unsharded
    ``preprocessing="device"`` inferer's; with exact postprocessing, to the
    JAX package's inferer on its (4, 2) mesh too. (Device postprocessing:
    JAX's inferer on its mesh compiles for half a minute; its sharded
    cleanup is held against the port's in ``test_banded_cleanup_equals_jax``,
    and the port's unsharded device mode against JAX's in
    ``tests/test_torch_postprocess_device.py``.)"""
    import lungmask_tpu

    vol = synthetic.lung_phantom(5, size=64)
    kw = dict(modelpath=weights["base" if fused else "single"], tqdm_disable=True,
              postprocessing_mode=post, precision="float32")
    if fused:
        kw.update(fillmodel="R231", fillmodel_path=weights["fill"])
    sharded = LMInferer(mesh=_cpu_mesh(4), **kw)
    pre = sharded.preprocess_image(vol)
    assert [[tuple(b.shape) for b in row] for row in pre["normalized"]] == (
        [[(2, 128, 256)] * 2] + [[(1, 128, 256)] * 2] * 3)
    got = sharded.apply(vol)
    assert got.any()
    np.testing.assert_array_equal(got, LMInferer(device="cpu", preprocessing="device",
                                                 **kw).apply(vol))
    if post == "exact":
        np.testing.assert_array_equal(got, lungmask_tpu.LMInferer(mesh=jmesh, **kw).apply(vol))


def _batch():
    """4 slices whose bands and halves differ in which classes they hold."""
    images = tp.blocky_slices(4, 64, 64, seed=6)
    labels = np.zeros((4, 64, 64), np.int32)
    labels[:2, 10:30, 8:40] = 1
    labels[2:, 16:50, 4:20] = 2
    labels[3, 40:60, 30:60] = 1
    return images, labels


@pytest.fixture(scope="module")
def jax_step(jmesh):
    """Loss and gradients of one f32 step of JAX's ``make_train_step`` on
    its (4, 2) mesh: an optimizer that keeps the gradients as its state and
    moves no weight."""
    from lungmask_tpu.train import init_train_state as jinit
    from lungmask_tpu.train import make_train_step as jmake

    params = tp.random_params(n_classes=3, wf=2, seed=1)
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    images, labels = _batch()
    state, loss = jmake(keep, mesh=jmesh, compute_dtype=jnp.float32)(
        jinit(params, keep), jnp.asarray(images), jnp.asarray(labels))
    return params, float(loss), jax.tree_util.tree_map(np.asarray, state.opt_state)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("shape", [(4, 2), (1, 2)])
def test_space_train_step_equals_jax(jax_step, shape, remat):
    """One f32 step over a (4, 2) and a (1, 2) mesh, ``remat`` off and on:
    the loss and every gradient leaf against JAX's step on its (4, 2)
    mesh."""
    params, jloss, jgrads = jax_step
    rec = tp.GradRecorder()
    state = init_train_state(convert.from_jax_params(params), rec)
    step = make_train_step(rec, mesh=_cpu_mesh(*shape), compute_dtype=torch.float32, remat=remat)
    _, loss = step(state, *_batch())
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    got = dict(_leaves(convert.to_jax_params(state.model.tree(rec.grads))))
    want = dict(_leaves(jgrads))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        scale = float(np.abs(want[path]).max())
        assert scale > 0, path
        np.testing.assert_allclose(g, want[path], rtol=0, atol=1e-4 * scale, err_msg=str(path))


def test_space_fit_lowers_the_loss():
    """A 5-step f32 ``fit`` over a (2, 2) mesh on one batch of 4 slices
    (JAX's ``tests/test_parallel.py::test_train_step_decreases_loss`` takes
    5 steps on one batch): every loss finite, the last below the first."""
    from lungmask_tpu_torch.train import fit
    from lungmask_tpu_torch.train.data import SliceDataset

    vol = synthetic.lung_phantom(4, size=64)
    ds = SliceDataset([(vol, (vol < -500).astype(np.uint8))], resolution=(64, 64), device="cpu")
    res = fit(convert.from_jax_params(tp.random_params(n_classes=3, wf=2, seed=1)), ds,
              epochs=5, batch_size=4, mesh=_cpu_mesh(2),
              optimizer=default_optimizer(5, peak_lr=1e-2), compute_dtype=torch.float32,
              log_every=1)
    losses = [h["loss"] for h in res.history if "loss" in h]
    assert len(losses) == 5 and res.state.step == 5
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
