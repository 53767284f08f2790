"""The port's LMInferer and CLI against the JAX package's, end to end.

At float32 on a small lung phantom with the crafted laterality weights
(wf=2) both packages must give the same mask voxel for voxel: the same
bodymask boxes, the same float64 host resample, U-Net logits that agree to
float32 rounding far from every class boundary, and the same native
postprocessing and paste-back.
"""

import functools
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

import torch_parity as tp  # (one torch thread per worker)
import lungmask_tpu
import lungmask_tpu.cli
import lungmask_tpu_torch
import lungmask_tpu_torch.cli
from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.inferer import resolve_device
from lungmask_tpu_torch.io import image, loader, nifti
from lungmask_tpu_torch.models import convert, registry, synthetic
from lungmask_tpu_torch.parallel import make_mesh
from lungmask_tpu_torch.runtime.engine import UNetRunner

N_SLICES, SIZE = 4, 160


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "laterality_wf2.npz")
    convert.save_npz(path, synthetic.laterality_params(wf=2))
    return path


@pytest.fixture(scope="module")
def lobes_weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "laterality6_wf2.npz")
    convert.save_npz(path, synthetic.laterality_params(n_classes=6, wf=2))
    return path


@pytest.fixture(scope="module")
def phantom():
    return synthetic.lung_phantom(N_SLICES, size=SIZE)


@pytest.fixture(scope="module")
def jax_inferers(weights):
    kw = dict(modelpath=weights, precision="float32", tqdm_disable=True, batch_size=2)
    return {
        post: lungmask_tpu.LMInferer(volume_postprocessing=post, **kw)
        for post in (True, False)
    }


def _ras_image(vol):
    """A non-LPS image (RAS: x and y flipped) with the phantom's voxels."""
    return image.MedicalImage(vol, spacing=(0.7, 0.7, 2.5), direction=np.diag([-1.0, -1.0, 1.0]))


@pytest.mark.parametrize("post", [True, False])
@pytest.mark.parametrize("kind", ["numpy", "image"])
def test_apply_equals_jax(weights, phantom, jax_inferers, kind, post):
    inp = phantom if kind == "numpy" else _ras_image(phantom)
    if kind == "image":
        assert inp.orientation() == "RAS"
    port = LMInferer(
        modelpath=weights, device="cpu", precision="float32", tqdm_disable=True,
        batch_size=2, volume_postprocessing=post,
    )
    got = port.apply(inp)
    want = jax_inferers[post].apply(inp)
    assert got.dtype == np.uint8 and got.shape == phantom.shape
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2}
    assert set(port.timings.summary()) == (
        {"to_lps", "preprocess", "unet", "postprocess", "paste_back", "from_lps"} if post
        else {"to_lps", "preprocess", "unet", "paste_back", "from_lps"}
    )


def test_split_phase_equals_apply(weights, phantom):
    port = LMInferer(modelpath=weights, device="cpu", precision="float32", tqdm_disable=True)
    pre = port.preprocess_image(_ras_image(phantom))
    assert pre["normalized"].shape == (N_SLICES, 256, 256)
    np.testing.assert_array_equal(port.apply_preprocessed(pre), port.apply(_ras_image(phantom)))


_STAGES = {"to_lps", "preprocess", "unet", "postprocess", "paste_back", "from_lps"}


@pytest.mark.parametrize("case", ["single, exact", "single, device", "fused, exact",
                                  "fused, device", "two-way mesh"])
def test_apply_is_the_three_phases(weights, lobes_weights, phantom, case):
    """``apply`` is the three phases for every 2-D model, and times the
    stages it timed before (the 3-D model's case is in
    ``test_torch_sliding_window.py``)."""
    kw = dict(modelpath=weights, precision="float32", tqdm_disable=True, batch_size=2,
              postprocessing_mode="device" if "device" in case else "exact")
    if case.startswith("fused"):
        kw.update(modelpath=lobes_weights, fillmodel_path=weights)
    if case == "two-way mesh":
        kw.update(mesh=make_mesh(devices=["cpu"] * 2), postprocessing_mode="device")
    else:
        kw["device"] = "cpu"
    port = LMInferer(**kw)
    stages = _STAGES | ({"fusion_postprocess"} if case.startswith("fused") else set())
    got = tp.assert_apply_is_the_three_phases(port, _ras_image(phantom), stages)
    assert got.shape == phantom.shape and got.any()


def test_deprecated_apply_takes_a_runner(weights, phantom, tmp_path, monkeypatch):
    """``lungmask_tpu_torch.apply(image, model=runner)`` runs the runner it
    was handed, not the named model the inferer loads first."""
    stem = os.path.splitext(os.path.basename(registry.MODEL_URLS["R231"][0]))[0]
    convert.save_npz(str(tmp_path / f"{stem}.npz"), synthetic.threshold_params(wf=2))
    monkeypatch.setenv("LUNGMASK_TPU_CACHE", str(tmp_path))
    params, n_classes = registry.get_model(modelpath=weights)
    runner = UNetRunner(params, n_classes, batch_size=20, device="cpu")
    runner.run_numpy = mock.Mock(wraps=runner.run_numpy)
    with pytest.warns(DeprecationWarning):
        got = lungmask_tpu_torch.apply(phantom, model=runner, force_cpu=True, tqdm_disable=True)
    assert runner.run_numpy.call_count == 1
    want = LMInferer(modelpath=weights, force_cpu=True, batch_size=20, tqdm_disable=True)
    np.testing.assert_array_equal(got, want.apply(phantom))


def test_cli_nifti_equals_jax_cli(weights, phantom, tmp_path):
    src = str(tmp_path / "in.nii.gz")
    nifti.write(_ras_image(phantom), src)
    f32 = "float32"
    with mock.patch.object(
        lungmask_tpu.cli, "LMInferer",
        functools.partial(lungmask_tpu.cli.LMInferer, precision=f32),
    ):
        lungmask_tpu.cli.main(
            [src, str(tmp_path / "jax.nii.gz"), "--modelpath", weights, "--noprogress",
             "--batchsize", "2"]
        )
    with mock.patch.object(
        lungmask_tpu_torch.cli, "LMInferer",
        functools.partial(lungmask_tpu_torch.cli.LMInferer, precision=f32),
    ):
        lungmask_tpu_torch.cli.main(
            [src, str(tmp_path / "port.nii.gz"), "--modelpath", weights, "--noprogress",
             "--cpu"]
        )
    got = loader.load_input_image(str(tmp_path / "port.nii.gz"))
    want = loader.load_input_image(str(tmp_path / "jax.nii.gz"))
    np.testing.assert_array_equal(got.array, want.array)
    np.testing.assert_allclose(got.direction, want.direction)
    assert got.orientation() == "RAS" and set(np.unique(got.array)) == {0, 1, 2}


def test_no_silent_cpu_fallback(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMInferer(modelpath=weights)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device(None, force_cpu=True).type == "cpu"
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("case", ["sharded without a mesh", "the space axis"])
def test_unported_options_raise(weights, phantom, case):
    """The mesh (items 10 and 10b) is ported: ``preprocessing="sharded"``
    needs one, and a mesh with a space axis runs, its mask equal to the
    unsharded device-preprocessing mask."""
    from lungmask_tpu_torch.parallel import make_mesh

    if case == "sharded without a mesh":
        with pytest.raises(ValueError, match="requires mesh"):
            LMInferer(modelpath=weights, device="cpu", preprocessing="sharded")
    else:
        kw = dict(modelpath=weights, tqdm_disable=True, precision="float32")
        inferer = LMInferer(mesh=make_mesh(devices=["cpu"] * 2, space=2), **kw)
        want = LMInferer(device="cpu", preprocessing="device", **kw).apply(phantom)
        np.testing.assert_array_equal(inferer.apply(phantom), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int8, np.bool_, np.int16, np.float32])
def test_hu_capable_promotion_equals_jax(dtype):
    arr = np.zeros((1, 2, 2), dtype)
    got = LMInferer._hu_dtype(arr.dtype)
    assert got == lungmask_tpu.LMInferer._hu_capable(arr).dtype


def test_loader_is_nifti_only(tmp_path, phantom):
    """The loader is no longer NIfTI only: a MetaImage written by the JAX
    package loads to the same image in both, and an unknown output
    extension raises ValueError in both without writing a file."""
    from lungmask_tpu.io import image as jimage
    from lungmask_tpu.io import loader as jloader

    path = str(tmp_path / "x.mha")
    jloader.write_image(jimage.MedicalImage(phantom, spacing=(0.7, 0.8, 2.5)), path)
    got, want = loader.load_input_image(path), jloader.load_input_image(path)
    np.testing.assert_array_equal(got.array, want.array)
    assert got.spacing == want.spacing == (0.7, 0.8, 2.5)
    np.testing.assert_array_equal(got.direction, want.direction)
    bad = str(tmp_path / "x.xyz")
    for load_mod, img_mod in ((loader, image), (jloader, jimage)):
        with pytest.raises(ValueError, match="unsupported output format"):
            load_mod.write_image(img_mod.MedicalImage(np.zeros((1, 2, 2), np.uint8)), bad)
    assert not os.path.exists(bad)
