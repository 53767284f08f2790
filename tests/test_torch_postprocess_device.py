"""Device postprocessing of the port against the JAX package: 3-D labels,
3-D hole filling, ``postprocess_device`` and its crumb-packed form, and the
inferer's ``postprocessing_mode="device"``, single model and fused.

Tolerance: none. Labels are int32 raster-first indices + 1, masks and class
maps are exact, so every output must equal JAX's bit for bit (and scipy's,
for the hole fill). JAX runs on the CPU as its own tests run it.
"""

import os
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import torch_parity  # noqa: F401  (one torch thread per worker)
import lungmask_tpu
from lungmask_tpu.ops import cc as jcc
from lungmask_tpu.ops import morphology as jmorph
from lungmask_tpu.transforms import postprocess_device as jpd
from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.models import convert, registry, synthetic
from lungmask_tpu_torch.ops import cc, morphology
from lungmask_tpu_torch.runtime.engine import unpack_crumbs
from lungmask_tpu_torch.transforms import postprocess
from lungmask_tpu_torch.transforms import postprocess_device as tpd

F32 = dict(precision="float32", tqdm_disable=True, batch_size=2)


def _class_map(seed: int, shape=(5, 12, 14), p: float = 0.45, n_classes: int = 4):
    rng = np.random.default_rng(seed)
    fg = rng.random(shape) < p
    return (fg * rng.integers(1, n_classes, shape)).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("connectivity", [1, 3])
@pytest.mark.parametrize("kind", ["bool", "classes"])
def test_label_3d_equals_jax(seed, connectivity, kind):
    img = _class_map(seed)
    if kind == "bool":
        img = img > 0
    got, rounds = cc.label_rounds(torch.from_numpy(img), connectivity, rank=3)
    want = np.asarray(jcc.label(jnp.asarray(img), connectivity=connectivity))
    assert got.dtype == torch.int32 and rounds >= 1
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cc.areas_by_root(got, rank=3).numpy(), np.asarray(jcc.areas_by_root(jnp.asarray(want)))
    )


def test_label_spiral_and_batched_images():
    """A spiral (every bend is a round of propagation for scan-based
    labelling) with a second value inside, labelled in 3-D, and a batch of
    two 3-D images, each labelled on its own."""
    img = np.zeros((33, 33), np.uint8)
    top, left, bottom, right = 0, 0, 32, 32
    while top < bottom and left < right:
        img[top, left : right + 1] = 1
        img[top : bottom + 1, right] = 1
        img[bottom, left : right + 1] = 1
        img[top + 2 : bottom + 1, left] = 1
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
    img[16, 16] = 2
    vol = np.stack([img, img.T, np.zeros_like(img)])
    want = np.asarray(jcc.label(jnp.asarray(vol)))
    np.testing.assert_array_equal(cc.label(torch.from_numpy(vol), rank=3).numpy(), want)
    pair = np.stack([vol, _class_map(7, vol.shape)])
    got = cc.label(torch.from_numpy(pair), rank=3).numpy()
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], cc.label(torch.from_numpy(pair[1]), rank=3).numpy())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("structure", ["cross", "full"])
def test_fill_holes_3d_equals_jax_and_scipy(seed, structure):
    rng = np.random.default_rng(seed)
    mask = rng.random((6, 13, 11)) < 0.6
    mask[2:5, 3:9, 3:8] = True
    mask[3, 5:7, 4:6] = False  # a closed cavity
    got, rounds = morphology.fill_holes_rounds(torch.from_numpy(mask), structure, rank=3)
    want = np.asarray(jmorph.binary_fill_holes(jnp.asarray(mask), structure=structure))
    np.testing.assert_array_equal(got.numpy(), want)
    st = None if structure == "cross" else np.ones((3, 3, 3))
    np.testing.assert_array_equal(got.numpy(), ndimage.binary_fill_holes(mask, structure=st))
    assert rounds >= 1 and not want[3, 5, 4] == mask[3, 5, 4]


def test_fill_holes_batched_equals_one_by_one():
    masks = np.random.default_rng(3).random((3, 5, 9, 10)) < 0.55
    got = morphology.binary_fill_holes(torch.from_numpy(masks), "cross", rank=3).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], ndimage.binary_fill_holes(masks[i]))


def _clean_pred():
    """Two lungs with holes and one-voxel specks (JAX's test volume)."""
    pred = np.zeros((4, 48, 48), dtype=np.uint8)
    yy, xx = np.mgrid[0:48, 0:48]
    pred[1:3, ((yy - 24) / 14.0) ** 2 + ((xx - 15) / 8.0) ** 2 < 1] = 1
    pred[1:3, ((yy - 24) / 14.0) ** 2 + ((xx - 33) / 8.0) ** 2 < 1] = 2
    pred[1, 22:25, 13:16] = 0
    pred[2, 22:25, 31:34] = 0
    pred[0, 2, 2] = 1
    pred[3, 40, 40] = 2
    return pred


def _lobe_phantom():
    """Five lobes plus satellites that the exact path remaps and the device
    path removes (JAX's ``tests/test_postprocess_device.py:67``)."""
    pred = np.zeros((12, 96, 96), dtype=np.uint8)
    yy, xx = np.mgrid[0:96, 0:96]

    def ellipse(cy, cx, ry, rx):
        return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1

    pred[2:10, ellipse(30, 28, 16, 12)] = 1
    pred[2:10, ellipse(62, 28, 16, 12)] = 2
    pred[2:10, ellipse(22, 68, 12, 11)] = 3
    pred[2:10, ellipse(48, 68, 12, 11)] = 4
    pred[2:10, ellipse(72, 68, 12, 11)] = 5
    satellites = np.zeros_like(pred, dtype=bool)
    for zs, ys, xs, v in ((slice(4, 6), slice(60, 64), slice(40, 44), 1),
                          (slice(5, 7), slice(70, 73), slice(79, 83), 4)):
        sat = np.zeros_like(satellites)
        sat[zs, ys, xs] = True
        sat &= pred == 0
        pred[sat] = v
        satellites |= sat
    pred[0, 2, 2:4] = 3
    return pred, satellites


def _tie_and_empty():
    """Class 1 has two components of equal area (the LAST must win), class
    2 is empty, class 3 holds one component with a cavity."""
    pred = np.zeros((4, 16, 16), np.uint8)
    pred[0:2, 1:4, 1:4] = 1
    pred[2:4, 10:13, 10:13] = 1
    pred[1:4, 5:10, 2:8] = 3
    pred[2, 7, 4] = 0
    return pred


VOLUMES = {
    "clean": (_clean_pred, 3),
    "lobes": (lambda: _lobe_phantom()[0], 6),
    "tie_empty": (_tie_and_empty, 4),
}


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_postprocess_device_equals_jax(name):
    make, n_classes = VOLUMES[name]
    pred = make()
    stats = {}
    got = tpd.postprocess_device(torch.from_numpy(pred), n_classes, stats).numpy()
    want = np.asarray(jpd.postprocess_device(jnp.asarray(pred), n_classes=n_classes))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert stats["label_rounds"] >= 1 and stats["fill_rounds"] >= 1
    if name == "tie_empty":
        assert got[2, 11, 11] == 1 and got[0, 2, 2] == 0  # the last of the tie wins
        assert got[2, 7, 4] == 3  # the cavity is filled
        assert not (got == 2).any()


@pytest.mark.parametrize("name", ["clean", "tie_empty"])
def test_packed2_equals_jax(name):
    make, n_classes = VOLUMES[name]
    pred = make()
    got = tpd.postprocess_device_packed2(torch.from_numpy(pred), n_classes).numpy()
    want = np.asarray(jpd.postprocess_device_packed2(jnp.asarray(pred), n_classes=n_classes))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        unpack_crumbs(got), tpd.postprocess_device(torch.from_numpy(pred), n_classes).numpy()
    )
    with pytest.raises(ValueError, match="crumb"):
        tpd.postprocess_device_packed2(torch.from_numpy(pred), 5)


def test_divergence_contract_against_exact():
    """On the merge-heavy lobe phantom device mode differs from the exact
    path on the satellites alone (removed here, remapped there)."""
    pred, satellites = _lobe_phantom()
    exact = postprocess.postprocessing(pred.copy(), disable_tqdm=True)
    dev = tpd.postprocess_device(torch.from_numpy(pred), 6).numpy()
    np.testing.assert_array_equal(dev != exact, satellites)
    assert np.all(dev[satellites] == 0) and np.all(exact[satellites] != 0)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "laterality_wf2.npz")
    convert.save_npz(path, synthetic.laterality_params(wf=2))
    return path


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = tmp_path_factory.mktemp("cache")
    for name, params in (
        ("LTRCLobes", synthetic.laterality_params(n_classes=6, wf=2)),
        ("R231", synthetic.threshold_params(wf=2)),
    ):
        stem = os.path.splitext(os.path.basename(registry.MODEL_URLS[name][0]))[0]
        convert.save_npz(str(path / f"{stem}.npz"), params)
    with mock.patch.dict(os.environ, {"LUNGMASK_TPU_CACHE": str(path)}):
        yield str(path)


@pytest.fixture(scope="module")
def phantom():
    return synthetic.lung_phantom(4, size=160)


def test_device_mode_apply_equals_jax(weights, phantom):
    port = LMInferer(modelpath=weights, device="cpu", postprocessing_mode="device", **F32)
    got = port.apply(phantom)
    want = lungmask_tpu.LMInferer(
        modelpath=weights, postprocessing_mode="device", **F32
    ).apply(phantom)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2}
    pre = port.preprocess_image(phantom)
    pred = port.forward_preprocessed(pre)
    assert isinstance(pred, torch.Tensor) and pred.device == port.device
    np.testing.assert_array_equal(port.finish_forward(pre, pred), got)


def test_fused_device_mode_equals_jax(cache, phantom, monkeypatch):
    kw = dict(modelname="LTRCLobes", fillmodel="R231", postprocessing_mode="device", **F32)
    port = LMInferer(device="cpu", **kw)
    assert not port._pipeline._fused_finish_threads()  # two device cleanups would only queue
    got = port.apply(phantom)
    want = lungmask_tpu.LMInferer(**kw).apply(phantom)
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("LUNGMASK_TPU_FUSED_THREADS", "1")
    np.testing.assert_array_equal(port.apply(phantom), got)


def test_unknown_postprocessing_mode_raises(weights):
    with pytest.raises(ValueError, match="postprocessing_mode"):
        LMInferer(modelpath=weights, device="cpu", postprocessing_mode="fast")
