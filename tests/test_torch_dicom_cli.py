"""The slice as a whole: a DICOM series (and a ``--noHU`` image stack)
through the port's CLI against the JAX CLI.

A 4-slice 64×64 lung phantom series with keep-listed patient and study tags
goes through ``lungmask-torch SERIES OUT --cpu`` and ``lungmask SERIES OUT``
at float32 with the crafted laterality weights (wf=2, carried into the port
by ``models/convert.from_jax_params``). The masks must be equal voxel for
voxel, with ``.nii.gz`` and with ``.dcm`` output; for ``.dcm`` every slice
file's tags must be equal too, the UIDs each writer draws and the file-meta
group length (0002|0000, which follows the SOP UID's length) included:
``dicom.generate_uid`` of both packages restarts one counter for each CLI
run, so both writers draw the same UIDs whatever ran before in the process.

Tolerance: none.
"""

import functools
import os
import unittest.mock as mock

import numpy as np
import pytest

import torch_parity
import lungmask_tpu.cli
import lungmask_tpu_torch.cli
from lungmask_tpu.io import dicom as jdicom
from lungmask_tpu.io import loader as jloader
from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.io import dicom, loader
from lungmask_tpu_torch.models import convert, synthetic

N_SLICES, SIZE = 4, 64
UID_ROOT = "1.2.826.0.1.3680043.10.1464.5"
PATIENT_TAGS = {
    (0x0008, 0x0020): "20260102",  # StudyDate
    (0x0008, 0x0050): "ACC42",  # AccessionNumber
    (0x0010, 0x0010): "DOE^JANE",  # PatientName
    (0x0010, 0x0020): "P0042",  # PatientID
    (0x0010, 0x0040): "F",  # PatientSex
    (0x0020, 0x0010): "S7",  # StudyID
    (0x0008, 0x1090): "not kept",  # ManufacturerModelName: off the keep list
}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "laterality_wf2.npz")
    convert.save_npz(path, synthetic.laterality_params(wf=2))
    return path


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    root = tmp_path_factory.mktemp("series")
    vol = synthetic.lung_phantom(N_SLICES, size=SIZE)
    for z in range(N_SLICES):
        dicom.write_slice(
            str(root / f"IM{N_SLICES - z:04d}"), vol[z], series_uid=f"{UID_ROOT}.2",
            study_uid=f"{UID_ROOT}.1", position=(-20.0, -30.0, 2.5 * z),
            spacing=(0.7, 0.7), slice_thickness=2.5, tags=PATIENT_TAGS,
        )
    return str(root), vol


def _restarted_uids():
    """``generate_uid`` for one CLI run: the same sequence every time."""
    counter = iter(range(1, 10**6))
    return lambda: f"{UID_ROOT}.9.{next(counter)}"


def _run_both(src, out_dir, out_name, weights, extra=()):
    """Both CLIs at float32 on ``src``, each with both packages' UID
    sequences restarted; returns the (port, jax) output paths."""
    outs = []
    for name, mod, flags in (
        ("port", lungmask_tpu_torch.cli, ["--cpu"]),
        ("jax", lungmask_tpu.cli, ["--batchsize", "2"]),
    ):
        os.makedirs(out_dir / name)
        outs.append(str(out_dir / name / out_name))
        with mock.patch.object(
            mod, "LMInferer", functools.partial(mod.LMInferer, precision="float32")
        ), mock.patch.object(dicom, "generate_uid", _restarted_uids()), mock.patch.object(
            jdicom, "generate_uid", _restarted_uids()
        ):
            mod.main([src, outs[-1], "--modelpath", weights, "--noprogress", *flags, *extra])
    return outs


def test_cli_dicom_to_nifti_equals_jax(weights, series, tmp_path):
    src, vol = series
    port, jax = _run_both(src, tmp_path, "mask.nii.gz", weights)
    got = loader.load_input_image(port)
    torch_parity.assert_same_image(got, jloader.load_input_image(jax))
    assert set(np.unique(got.array)) == {0, 1, 2}
    image = loader.load_input_image(src)
    np.testing.assert_array_equal(got.array, LMInferer(
        modelpath=weights, device="cpu", precision="float32", tqdm_disable=True).apply(image))
    assert got.array.shape == vol.shape
    np.testing.assert_allclose(got.spacing, (0.7, 0.7, 2.5), rtol=1e-6)  # NIfTI float32


def test_cli_dicom_to_dicom_equals_jax(weights, series, tmp_path):
    src, _ = series
    port, jax = _run_both(src, tmp_path, "mask.dcm", weights)
    leaves = sorted(os.listdir(os.path.dirname(port)))
    assert leaves == [f"mask_{z:04d}.dcm" for z in range(N_SLICES)]
    assert leaves == sorted(os.listdir(os.path.dirname(jax)))
    for leaf in leaves:
        got = dicom.read_file(os.path.join(os.path.dirname(port), leaf))
        want = dicom.read_file(os.path.join(os.path.dirname(jax), leaf))
        np.testing.assert_array_equal(got.pixels, want.pixels)
        assert got.tags == want.tags
        assert got.get("0008|0018").startswith(f"{UID_ROOT}.9.")
        assert got.get("0010|0010") == "DOE^JANE" and got.get("0020|0010") == "S7"
        assert got.get("0008|103e") == "Created with lungmask"
        assert got.get("0028|1050") == "1" and got.get("0028|1051") == "2"
        assert "0008|1090" not in got.tags  # off the keep list
        assert got.get("0020|000d") == f"{UID_ROOT}.1"
    back = loader.read_dicoms(os.path.dirname(port), read_metadata=True)[0]
    jback = jloader.read_dicoms(os.path.dirname(jax), read_metadata=True)[0]
    torch_parity.assert_same_image(back, jback)
    assert set(np.unique(back.array)) == {0, 1, 2}


def test_cli_nohu_stack_equals_jax(weights, tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    stack = tmp_path / "stack"
    stack.mkdir()
    vol = synthetic.lung_phantom(3, size=SIZE).astype(np.float64)
    eight_bit = np.clip((vol + 1024) / 1624 * 255, 0, 255).astype(np.uint8)
    for z, sl in enumerate(eight_bit):
        Image.fromarray(sl).save(stack / f"slice{z}.png")
    port, jax = _run_both(str(stack), tmp_path, "mask.nii.gz", weights, extra=["--noHU"])
    got = loader.load_input_image(port)
    torch_parity.assert_same_image(got, jloader.load_input_image(jax))
    assert got.array.shape == eight_bit.shape and set(np.unique(got.array)) == {0, 1, 2}
    with pytest.raises(SystemExit):
        lungmask_tpu_torch.cli.main([str(stack), str(tmp_path / "o"), "--cohort", "--noHU",
                                     "--modelpath", weights, "--cpu"])
