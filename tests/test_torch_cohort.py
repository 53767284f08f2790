"""The port's cohort runtime against the JAX package's, and the error cases
of JAX's ``tests/test_cohort.py``.

Tolerance: none. At float32 with the crafted laterality weights every mask
the cohort writes or keeps must equal JAX's cohort mask and the port's own
``apply`` voxel for voxel, in exact and in device postprocessing.
"""

import os

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
import lungmask_tpu
from lungmask_tpu.runtime.cohort import run_cohort as jax_run_cohort
from lungmask_tpu_torch import LMInferer, cli
from lungmask_tpu_torch.io import dicom, loader, nifti
from lungmask_tpu_torch.io.image import MedicalImage
from lungmask_tpu_torch.models import convert, synthetic
from lungmask_tpu_torch.runtime.cohort import run_cohort

F32 = dict(precision="float32", tqdm_disable=True, batch_size=2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "laterality_wf2.npz")
    convert.save_npz(path, synthetic.laterality_params(wf=2))
    return path


@pytest.fixture(scope="module")
def inferer(weights):
    return LMInferer(modelpath=weights, device="cpu", **F32)


def _vol(seed, n=2, hw=64):
    """A lung phantom (the 64² slices take the strict host preprocessing),
    shifted in HU by the seed so that volumes differ."""
    return synthetic.lung_phantom(n, size=hw) + np.int16(3 * seed)


@pytest.mark.parametrize("mode", ["exact", "device"])
def test_cohort_masks_equal_jax_and_apply(weights, inferer, tmp_path, mode):
    port = inferer if mode == "exact" else LMInferer(
        modelpath=weights, device="cpu", postprocessing_mode=mode, **F32
    )
    vols = [_vol(i, hw=hw) for i, hw in enumerate((64, 64, 160))]
    paths = []
    for i, v in enumerate(vols):
        paths.append(str(tmp_path / f"case{i}.nii.gz"))
        nifti.write(MedicalImage(v, spacing=(0.7, 0.8, 2.5)), paths[-1])
    out = tmp_path / "out"
    out.mkdir()
    stats = run_cohort(paths, port, output_dir=str(out), keep_masks=True)
    want = jax_run_cohort(
        paths, lungmask_tpu.LMInferer(modelpath=weights, postprocessing_mode=mode, **F32),
        keep_masks=True,
    )
    assert [r.error for r in stats.results] == [None] * 3
    assert [r.name for r in stats.results] == [r.name for r in want.results]
    assert sorted(os.listdir(out)) == [f"case{i}_mask.nii.gz" for i in range(3)]
    for r, w, v, p in zip(stats.results, want.results, vols, paths):
        np.testing.assert_array_equal(r.mask, w.mask)
        np.testing.assert_array_equal(r.mask, port.apply(nifti.read(p)))
        np.testing.assert_array_equal(nifti.read(str(out / f"{r.name}_mask.nii.gz")).array, r.mask)
        assert r.mask.shape == v.shape
    assert stats.volumes_per_hour > 0
    assert set(stats.stage_seconds) == {
        "load_busy", "load_wait", "forward_busy", "forward_wait", "forward_backpressure",
        "finish_busy", "finish_wait",
    }


def test_cohort_arrays_in_order(inferer):
    vols = [_vol(i) for i in range(5)]
    stats = run_cohort(vols, inferer, prefetch=3, keep_masks=True)
    assert [r.name for r in stats.results] == [f"volume{i:04d}" for i in range(5)]
    assert all(r.error is None for r in stats.results)
    for r, v in zip(stats.results, vols):
        np.testing.assert_array_equal(r.mask, inferer.apply(v))


def test_cohort_skips_bad_volume(inferer, tmp_path):
    """A missing file and a directory without DICOM fail their volumes ("No
    dicoms found"); a DICOM series directory beside them segments."""
    bad = str(tmp_path / "missing.nii.gz")
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "notes.txt").write_text("no dicom here")
    series = tmp_path / "series"
    series.mkdir()
    _write_series(series, _vol(4))
    stats = run_cohort([_vol(0), bad, str(empty), str(series)], inferer, keep_masks=True)
    assert len(stats.results) == 4
    errs = [r for r in stats.results if r.error is not None]
    assert [r.name for r in errs] == ["missing", "empty"]
    assert "No dicoms found" in errs[1].error
    assert stats.results[0].mask is not None
    np.testing.assert_array_equal(
        stats.results[3].mask, inferer.apply(loader.load_input_image(str(series))))


def _write_series(root, vol, spacing=(0.7, 0.8), thickness=2.5):
    for z, sl in enumerate(vol):
        dicom.write_slice(str(root / f"{z:03d}.dcm"), sl, series_uid=f"1.2.826.{root.name}",
                          study_uid="1.2.826.7", position=(0.0, 0.0, thickness * z),
                          spacing=spacing, slice_thickness=thickness)


@pytest.mark.parametrize("mode", ["exact", "device"])
def test_cohort_dicom_dirs_equal_jax(weights, inferer, tmp_path, mode):
    """Per-patient DICOM directories (all named DICOM, as exports often
    are) beside a NIfTI file: the same masks and mask names as JAX's
    cohort, and each mask equal to ``apply``'s."""
    port = inferer if mode == "exact" else LMInferer(
        modelpath=weights, device="cpu", postprocessing_mode=mode, **F32
    )
    sources = []
    for i, hw in enumerate((64, 160)):
        d = tmp_path / f"patient{i}" / "DICOM"
        d.mkdir(parents=True)
        _write_series(d, _vol(i, hw=hw))
        sources.append(str(d))
    sources.append(str(tmp_path / "CT.nii.gz"))
    nifti.write(MedicalImage(_vol(5), spacing=(0.7, 0.8, 2.5)), sources[-1])
    out, jout = tmp_path / "out", tmp_path / "jout"
    out.mkdir()
    jout.mkdir()
    stats = run_cohort(sources, port, output_dir=str(out), keep_masks=True)
    want = jax_run_cohort(
        sources, lungmask_tpu.LMInferer(modelpath=weights, postprocessing_mode=mode, **F32),
        output_dir=str(jout), keep_masks=True,
    )
    assert [r.error for r in stats.results] == [None] * 3
    assert [r.name for r in stats.results] == [r.name for r in want.results] == [
        "DICOM", "DICOM_0001", "CT"]
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    for r, w, src in zip(stats.results, want.results, sources):
        np.testing.assert_array_equal(r.mask, w.mask)
        np.testing.assert_array_equal(r.mask, port.apply(loader.load_input_image(src)))
        np.testing.assert_array_equal(nifti.read(str(out / f"{r.name}_mask.nii.gz")).array, r.mask)


def test_cohort_on_result_exception_does_not_hang(inferer):
    """A raising on_result callback must not kill the finisher thread (which
    would deadlock the bounded queue); the error lands on that result."""
    calls = []

    def bad_cb(res):
        calls.append(res.name)
        raise RuntimeError("observer crashed")

    stats = run_cohort([_vol(i) for i in range(4)], inferer, on_result=bad_cb, keep_masks=True)
    assert len(stats.results) == 4 and len(calls) == 4
    assert all("on_result failed" in (r.error or "") for r in stats.results)
    assert all(r.mask is not None for r in stats.results)


def test_cohort_duplicate_names_not_overwritten(tmp_path, inferer):
    a, b = tmp_path / "patientA", tmp_path / "patientB"
    a.mkdir()
    b.mkdir()
    for d, seed in ((a, 1), (b, 2)):
        nifti.write(MedicalImage(_vol(seed)), str(d / "CT.nii.gz"))
    out = tmp_path / "out"
    out.mkdir()
    stats = run_cohort([str(a / "CT.nii.gz"), str(b / "CT.nii.gz")], inferer, output_dir=str(out))
    assert all(r.error is None for r in stats.results)
    assert sorted(os.listdir(out)) == ["CT_0001_mask.nii.gz", "CT_mask.nii.gz"]


def test_cohort_failing_source_iterator(inferer):
    def gen():
        yield _vol(0)
        yield _vol(1)
        raise OSError("listing failed")

    stats = run_cohort(gen(), inferer)
    errors = [r for r in stats.results if r.error]
    assert len(stats.results) == 3
    assert len(errors) == 1 and "source iteration failed" in errors[0].error


def test_cli_cohort(weights, inferer, tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    vols = {f"v{i}": _vol(i) for i in range(4)}
    for name in ("v0", "v1"):
        nifti.write(MedicalImage(vols[name]), str(src / f"{name}.nii"))
    (src / "v2").mkdir()
    _write_series(src / "v2", vols["v2"])
    loader.write_image(MedicalImage(vols["v3"]), str(src / "v3.mha"))
    (src / "notes.txt").write_text("not a volume")
    out = tmp_path / "out"
    cli.main([str(src), str(out), "--cohort", "--modelpath", weights, "--cpu", "--noprogress"])
    assert sorted(os.listdir(out)) == [f"v{i}_mask.nii.gz" for i in range(4)]
    for name, v in vols.items():
        got = nifti.read(str(out / f"{name}_mask.nii.gz")).array
        np.testing.assert_array_equal(got, inferer.apply(v))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="No volumes"):
        cli.main([str(empty), str(out), "--cohort", "--modelpath", weights, "--cpu"])
