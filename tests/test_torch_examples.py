"""The port's examples (``examples/torch/``) run as a user runs them, on the
CPU (``--cpu``), on tiny synthetic data.

Weights come through the registry, as a user's do: ``$LUNGMASK_TPU_CACHE``
points at a temporary directory that holds the converted ``.npz`` of each
named model, and every entry of the port's ``MODEL_URLS`` points at a
``file://`` URL under the test's directory, so nothing can be fetched from
the network. Masks compare voxel for voxel with ``LMInferer(...).apply`` on
the same input (no tolerance).
"""

import glob
import importlib.util
import os

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from lungmask_tpu.models import registry as jregistry
from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.io import image, loader
from lungmask_tpu_torch.models import convert, registry, synthetic, unet

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "torch")
WF = 2
N_SLICES, SIZE = 6, 64


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    """A weight cache holding R231 (the crafted laterality weights) and
    LTRCLobes (their 6-class version), the release URLs pointing under the
    test's directory."""
    release = tmp_path / "release"
    release.mkdir()
    for name, (url, n) in list(registry.MODEL_URLS.items()):
        monkeypatch.setitem(registry.MODEL_URLS, name,
                            ((release / os.path.basename(url)).as_uri(), n))
    path = tmp_path / "cache"
    monkeypatch.setenv("LUNGMASK_TPU_CACHE", str(path))
    for name, params in (("R231", synthetic.laterality_params(wf=WF)),
                         ("LTRCLobes", synthetic.laterality_params(n_classes=6, wf=WF))):
        convert.save_npz(registry._npz_cache_path(name), params)
    return path


def _volume(tmp_path, stem, n=N_SLICES):
    path = str(tmp_path / f"{stem}.nii.gz")
    loader.write_image(image.MedicalImage(synthetic.lung_phantom(n, size=SIZE),
                                          spacing=(0.7, 0.7, 2.5)), path)
    return path


@pytest.mark.parametrize("lobes", [False, True], ids=["r231", "lobes"])
def test_segment_volume(tmp_path, cache, capsys, lobes):
    src, dst = _volume(tmp_path, "ct"), str(tmp_path / "mask.nii.gz")
    load_example("segment_volume").main([src, dst, "--cpu"] + ["--lobes"] * lobes)
    out = capsys.readouterr().out
    assert f"wrote {dst}" in out and "unet" in out  # the stage seconds
    kw = dict(modelname="LTRCLobes", fillmodel="R231") if lobes else {}
    want = LMInferer(force_cpu=True, tqdm_disable=True, **kw).apply(
        loader.load_input_image(src))
    got = loader.load_input_image(dst).array
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) >= {1, 2}


def test_segment_volume_needs_cuda_or_cpu(tmp_path, cache):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example("segment_volume").main([_volume(tmp_path, "ct"),
                                             str(tmp_path / "m.nii.gz")])


def test_cohort_streaming(tmp_path, cache, capsys):
    srcs = [_volume(tmp_path, "a"), _volume(tmp_path, "b", n=4)]
    out = tmp_path / "out"
    out.mkdir()  # run_cohort writes into an existing directory, as the JAX lane does
    stats = load_example("cohort_streaming").main([str(out)] + srcs + ["--cpu"])
    assert "2 volumes in" in capsys.readouterr().out
    assert [r.error for r in stats.results] == [None, None]
    inferer = LMInferer(force_cpu=True, tqdm_disable=True)
    for stem, src in zip("ab", srcs):
        got = loader.load_input_image(str(out / f"{stem}_mask.nii.gz")).array
        np.testing.assert_array_equal(got, inferer.apply(loader.load_input_image(src)))


def test_finetune(tmp_path, cache, capsys):
    """Two epochs at 64² from the cached R231 (a narrow depth-3 tree); the
    written weights load in both packages' ``get_model(modelpath=)``."""
    convert.save_npz(registry._npz_cache_path("R231"), convert.to_jax_params(
        unet.init_params(3, depth=3, wf=WF, generator=torch.Generator().manual_seed(0))))
    data = tmp_path / "data"
    data.mkdir()
    for i in range(3):
        vol = synthetic.lung_phantom(4 + i, size=SIZE)
        lungs = ((vol > -900) & (vol < -500)).astype(np.uint8)  # both lungs as class 1
        loader.write_image(image.MedicalImage(vol), str(data / f"case{i}.nii.gz"))
        loader.write_image(image.MedicalImage(lungs), str(data / f"case{i}_mask.nii.gz"))
    out = str(tmp_path / "tuned.npz")
    load_example("finetune").main([str(data), out, "--epochs", "2", "--resolution", "64",
                                   "--cpu"])
    assert "best eval macro Dice" in capsys.readouterr().out
    assert glob.glob(str(tmp_path / "tuned-trainstate*"))
    params, meta = convert.load_npz(out)
    assert meta["finetuned_from"] == "R231" and "eval_macro_dice" in meta
    for reg in (registry, jregistry):
        loaded, n_classes = reg.get_model(modelpath=out)
        assert n_classes == 3 and len(loaded["down"]) == 3
