"""The fused two-model mode (``LTRCLobes`` + ``R231`` fill) of the port
against the JAX package's, end to end.

Weights: the crafted numpy parameters at wf=2 — ``laterality_params`` with 6
classes as the base (LTRCLobes) and ``threshold_params`` as the fill
(R231), written as ``.npz`` into a temporary ``$LUNGMASK_TPU_CACHE`` under
the registry's names, which both packages read.

Tolerance: none. At float32 the two packages must give the same fused mask
voxel for voxel (the single-model masks already agree, see
``test_torch_inferer.py``, and the fusion is the shared native core), and
the paired engine's packed bytes must equal the JAX engine's.
"""

import functools
import os
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
import lungmask_tpu
import lungmask_tpu.cli
import lungmask_tpu_torch
import lungmask_tpu_torch.cli
from lungmask_tpu.runtime import engine as jeng
from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.io import image, loader, nifti
from lungmask_tpu_torch.models import convert, registry, synthetic
from lungmask_tpu_torch.ops import native
from lungmask_tpu_torch.runtime import engine as teng

N_SLICES, SIZE = 4, 160
F32 = dict(precision="float32", tqdm_disable=True, batch_size=2)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A weight cache holding both models under the registry's file names."""
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
    return synthetic.lung_phantom(N_SLICES, size=SIZE)


def _fused(make, **kw):
    return make(modelname="LTRCLobes", fillmodel="R231", **F32, **kw)


@pytest.fixture(scope="module")
def jax_fused(cache):
    return {
        post: _fused(lungmask_tpu.LMInferer, volume_postprocessing=post) for post in (True, False)
    }


def _ras_image(vol):
    return image.MedicalImage(vol, spacing=(0.7, 0.7, 2.5), direction=np.diag([-1.0, -1.0, 1.0]))


@pytest.mark.parametrize("post", [True, False])
@pytest.mark.parametrize("kind", ["numpy", "image"])
def test_fused_apply_equals_jax(cache, phantom, jax_fused, kind, post):
    inp = phantom if kind == "numpy" else _ras_image(phantom)
    port = _fused(LMInferer, device="cpu", volume_postprocessing=post)
    assert port.model.n_classes == 6 and port.fillmodelm.n_classes == 3
    got = port.apply(inp)
    want = jax_fused[post].apply(inp)
    assert got.dtype == np.uint8 and got.shape == phantom.shape
    np.testing.assert_array_equal(got, want)
    assert {1, 2} <= set(np.unique(got)) <= set(range(6))
    assert "fusion_postprocess" in port.timings.summary()


def test_fused_equals_fused_finish_of_the_single_models(cache, phantom):
    fused = _fused(LMInferer, device="cpu").apply(phantom)
    base = LMInferer(modelname="LTRCLobes", device="cpu", **F32).apply(phantom)
    fill = LMInferer(modelname="R231", device="cpu", **F32).apply(phantom)
    np.testing.assert_array_equal(fused, native.fused_finish(base, fill))
    assert not np.array_equal(fused, base)  # the fill model changed the mask


@pytest.mark.parametrize("native_finish", [True, False])
def test_threaded_and_sequential_finish_are_equal(cache, phantom, monkeypatch, native_finish):
    """The two per-model finishes on two threads or one after the other, and
    the numpy fusion that stands in when the native call returns None."""
    port = _fused(LMInferer, device="cpu")
    monkeypatch.setenv("LUNGMASK_TPU_FUSED_THREADS", "0")
    seq = port.apply(phantom)
    if not native_finish:
        monkeypatch.setattr(native, "fused_finish", lambda a, b: None)
    monkeypatch.setenv("LUNGMASK_TPU_FUSED_THREADS", "1")
    np.testing.assert_array_equal(port.apply(phantom), seq)


def test_split_phase_carries_the_pair(cache, phantom):
    port = _fused(LMInferer, device="cpu")
    pre = port.preprocess_image(_ras_image(phantom))
    pred = port.forward_preprocessed(pre)
    assert [p.shape for p in pred] == [(N_SLICES, 256, 256)] * 2
    np.testing.assert_array_equal(port.finish_forward(pre, pred), port.apply(_ras_image(phantom)))


@pytest.mark.parametrize("n_classes", [(6, 3), (3, 6)])
def test_pair_packed_bytes_equal_jax(n_classes):
    seeds = {3: 1, 6: 3}  # weights whose class maps are not constant on these slices
    pa_params = tp.random_params(n_classes=n_classes[0], wf=2, seed=seeds[n_classes[0]])
    pb_params = tp.random_params(n_classes=n_classes[1], wf=2, seed=seeds[n_classes[1]])
    vol = tp.blocky_slices(5, 64, 64, seed=4)[..., 0]
    padded = jnp.asarray(np.concatenate([vol, np.zeros((1, 64, 64), np.float32)]))
    bits = [teng.pack_bits_for(k, 64) for k in n_classes]
    want = jeng.volume_argmax_pair_packed(pa_params, pb_params, padded, 2, jnp.float32, *bits)
    a = teng.UNetRunner(pa_params, n_classes[0], batch_size=2, compute_dtype=torch.float32)
    b = teng.UNetRunner(pb_params, n_classes[1], batch_size=2, compute_dtype=torch.float32)
    got = teng.volume_argmax_pair_packed(a.model, b.model, torch.from_numpy(vol), 2, *bits)
    for g, w, nbits in zip(got, want, bits):
        assert g.shape == (5, 64, 64 * nbits // 8) and g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:5])
        assert len(np.unique(teng.unpack_bits_np(g.numpy(), nbits))) >= 2
    dense = teng.run_pair_numpy(a, b, torch.from_numpy(vol))
    np.testing.assert_array_equal(dense[0], a.run_numpy(torch.from_numpy(vol)))
    np.testing.assert_array_equal(dense[1], b.run_numpy(torch.from_numpy(vol)))


def test_fused_finish_binding_guards():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 3, (3, 8, 8), dtype=np.uint8)
    assert native.fused_finish(a[:1], a[:1]) is None  # fewer than 2 slices
    assert native.fused_finish(a.astype(np.int32), a) is None
    assert native.fused_finish(a, a[:, :4]) is None
    assert native.fused_finish(a, a).dtype == np.uint8


def test_cli_fused_equals_jax_cli(cache, phantom, tmp_path):
    src = str(tmp_path / "in.nii.gz")
    nifti.write(_ras_image(phantom), src)
    argv = ["--modelname", "LTRCLobes_R231", "--noprogress"]
    with mock.patch.object(
        lungmask_tpu.cli, "LMInferer",
        functools.partial(lungmask_tpu.cli.LMInferer, precision="float32"),
    ):
        lungmask_tpu.cli.main([src, str(tmp_path / "jax.nii.gz"), *argv, "--batchsize", "2"])
    with mock.patch.object(
        lungmask_tpu_torch.cli, "LMInferer",
        functools.partial(lungmask_tpu_torch.cli.LMInferer, precision="float32"),
    ):
        lungmask_tpu_torch.cli.main([src, str(tmp_path / "port.nii.gz"), *argv, "--cpu"])
    got = loader.load_input_image(str(tmp_path / "port.nii.gz"))
    want = loader.load_input_image(str(tmp_path / "jax.nii.gz"))
    np.testing.assert_array_equal(got.array, want.array)
    assert got.orientation() == "RAS" and {1, 2} <= set(np.unique(got.array))


def test_cli_fused_refuses_modelpath(cache, phantom, tmp_path):
    src = str(tmp_path / "in.nii.gz")
    nifti.write(image.MedicalImage(phantom), src)
    weights = os.path.join(cache, os.listdir(cache)[0])
    with pytest.raises(SystemExit):
        lungmask_tpu_torch.cli.main(
            [src, str(tmp_path / "o.nii.gz"), "--modelname", "LTRCLobes_R231",
             "--modelpath", weights, "--cpu"]
        )
    assert not os.path.exists(tmp_path / "o.nii.gz")


def test_deprecated_functional_api(cache, phantom):
    vol = phantom[:2]
    with pytest.warns(DeprecationWarning):
        fused = lungmask_tpu_torch.apply_fused(vol, force_cpu=True, tqdm_disable=True)
    want = LMInferer(
        modelname="LTRCLobes", fillmodel="R231", force_cpu=True, batch_size=20, tqdm_disable=True
    ).apply(vol)
    np.testing.assert_array_equal(fused, want)
    with pytest.warns(DeprecationWarning):
        single = lungmask_tpu_torch.apply(vol, force_cpu=True, tqdm_disable=True)
    assert single.shape == vol.shape and single.dtype == np.uint8


def test_unknown_fill_model_raises():
    with pytest.raises(ValueError, match="Modelname not found"):
        LMInferer(fillmodel="R232", device="cpu")
