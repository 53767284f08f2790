"""nnU-Net's sliding window in the port (``runtime/sliding_window.py``) and
the 3-D model on ``LMInferer``'s normal path (``apply``, the split phases,
``lungmask INPUT OUTPUT --modelpath``), with its export kernel (b)
(``ops/kernels/export3d``), against the plain reference of the benchmark
(``portbench/reference/nnunet3d.py``) at a small size, on the CPU; the
kernel against its plain version on the card (``cuda``).

Tolerances, each with its reason:

* the window's float32 logits: per class 1e-5 of the scale of the head's
  terms (``reference.nnunet3d.class_gap``); the two differ by float32
  rounding only;
* float32 masks: at most 0.1% of voxels apart, those where two classes'
  logits tie to within that rounding (the reference resamples in float64,
  the port in float32);
* the plain export against the reference's export of the same logits:
  the same 0.1%, for the same reason;
* the kernel against its plain version: ≤ 1e-5 of the bytes, where its
  fused multiply-adds round otherwise at a tie.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from lungmask_tpu_torch import LMInferer, cli
from lungmask_tpu_torch.io import loader
from lungmask_tpu_torch.io.image import MedicalImage
from lungmask_tpu_torch.models import convert, unet3d
from lungmask_tpu_torch.ops.kernels import export3d
from lungmask_tpu_torch.runtime import sliding_window as sw
from portbench.reference import nnunet3d as ref
from portbench.reference import pipeline

PLAN = {
    "architecture": "nnunet3d", "in_channels": 1, "features": [4, 8, 16, 16],
    "convs_per_stage": 2, "decoder_convs_per_stage": 2, "kernel": 3, "strides": [1, 2, 2, 2],
    "norm_eps": 1e-5, "leaky_slope": 0.01, "patch": [32, 32, 32], "spacing": 1.5, "step": 0.5,
    "sigma_scale": 0.125, "data_order": 3, "logit_order": 1, "n_classes": 6,
    "patches_per_forward": 2, "ct": {"mean": -700.0, "std": 200.0, "lower": -1024.0, "upper": 300.0},
}
RAS = np.diag([-1.0, -1.0, 1.0])
SPACING = (0.8, 0.9, 2.0)  # (x, y, z)


def _params(seed=0):
    p = unet3d.init_params(PLAN, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    return {k: (v + 0.5 * rng.standard_normal(v.shape)).astype(np.float32) if v.ndim == 1 else v
            for k, v in p.items()}


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("m") / "nnunet3d_tiny.npz")
    p = _params()
    convert.save_npz(path, p, meta={"architecture": "nnunet3d", "plan": PLAN})
    return path, p


@pytest.fixture(scope="module")
def image():
    """A small CT-like RAS volume: air with a frame of zeros (cropped), a
    body and two lungs, noise."""
    rng = np.random.default_rng(11)
    d, h, w = 26, 50, 56
    yy, xx = np.mgrid[0:h, 0:w]
    body = ((yy - h / 2) / (0.4 * h)) ** 2 + ((xx - w / 2) / (0.42 * w)) ** 2 < 1
    lungs = (((yy - h / 2) / (0.25 * h)) ** 2 + ((xx - w / 3) / (0.12 * w)) ** 2 < 1) | \
            (((yy - h / 2) / (0.25 * h)) ** 2 + ((xx - 2 * w / 3) / (0.12 * w)) ** 2 < 1)
    sl = np.full((h, w), -1000, np.int16)
    sl[body], sl[lungs] = 40, -800
    vol = np.repeat(sl[None], d, 0) + rng.integers(-30, 30, (d, h, w)).astype(np.int16)
    vol[:, :2], vol[:, :, -3:] = 0, 0
    return MedicalImage(vol, spacing=SPACING, direction=RAS)


def _reference_mask(img, p):
    """The reference pipeline in float32: LPS, preprocessing, window,
    export, back to the image's orientation."""
    axes = pipeline.flips(img.direction)
    lps = np.ascontiguousarray(np.flip(img.array, axes))
    x, box, crop = ref.preprocess(lps, tuple(reversed(img.spacing)), PLAN)
    lg, _ = ref.sliding_window(ref.tensors(p, "cpu"), x, PLAN, "cpu")
    return np.flip(ref.export(lg, box, crop, lps.shape), axes)


@pytest.mark.parametrize("shape", [(40, 50, 30), (20, 33, 45)])
def test_window_logits_match_reference(shape):
    """Overlapping patches, and a volume under the patch (padded)."""
    p = _params()
    vol = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    r = sw.SlidingWindowRunner(p, PLAN, "cpu", torch.float32)
    before = sw.PATCHES.value
    got = r.logits(torch.from_numpy(vol)).numpy()
    padded = [n + a + b for n, (a, b) in zip(shape, sw.padding(shape, PLAN["patch"]))]
    assert sw.PATCHES.value - before == len(r.windows(padded))
    want, scale = ref.sliding_window(ref.tensors(p, "cpu"), vol, PLAN, "cpu")
    assert got.shape == want.shape == (6,) + shape
    assert ref.class_gap(got, want, scale) <= 1e-5


def test_apply_split_phases_and_reference_agree(model, image):
    path, p = model
    inf = LMInferer(modelpath=path, device="cpu", precision="float32", tqdm_disable=True,
                    volume_postprocessing=False)
    got = inf.apply(image)
    pre = inf.preprocess_image(image)
    split = inf.finish_forward(pre, inf.forward_preprocessed(pre))
    assert got.dtype == np.uint8 and got.shape == image.array.shape
    assert np.array_equal(got, split)
    assert pre["box"] == (0, 26, 0, 48, 3, 56)  # the zero frame, in LPS
    assert {"to_lps", "preprocess", "unet", "export", "from_lps"} <= set(inf.timings.totals)
    want = _reference_mask(image, p)
    assert np.mean(got != want) <= 1e-3
    assert len(np.unique(got)) >= 3


def test_apply_is_the_three_phases(model, image):
    """``apply`` of a 3-D model is the three phases, as for the 2-D models
    (``test_torch_inferer.py``), and times the stages it timed before."""
    inf = LMInferer(modelpath=model[0], device="cpu", precision="float32", tqdm_disable=True)
    got = tp.assert_apply_is_the_three_phases(
        inf, image, {"to_lps", "preprocess", "unet", "export", "postprocess", "from_lps"})
    assert got.shape == image.array.shape and got.any()


def test_cli_runs_a_3d_model(model, image, tmp_path):
    path, _ = model
    src, out = str(tmp_path / "ct.nii.gz"), str(tmp_path / "mask.nii.gz")
    loader.write_image(image, src)
    cli.main([src, out, "--modelpath", path, "--cpu", "--noprogress"])
    got = loader.load_input_image(out).array
    inf = LMInferer(modelpath=path, force_cpu=True, tqdm_disable=True)
    want = inf.apply(loader.load_input_image(src))
    assert np.array_equal(got, want)
    assert "postprocess" in inf.timings.totals


@pytest.mark.parametrize("kwargs,named", [
    ({"fillmodel": "R231"}, "fillmodel"),
    ({"preprocessing": "hybrid"}, "preprocessing"),
    ({"postprocessing_mode": "device"}, "postprocessing_mode"),
    ({"mesh": "a mesh"}, "mesh"),
])
def test_3d_model_refuses_what_it_cannot_run(model, kwargs, named):
    with pytest.raises(ValueError, match=f"3-D model.*{named}"):
        LMInferer(modelpath=model[0], device="cpu", **kwargs)


@pytest.mark.parametrize("order", [0, 3])
def test_3d_model_refuses_a_logit_order_the_export_lacks(model, tmp_path, order):
    path = str(tmp_path / f"logit_order{order}.npz")
    convert.save_npz(path, model[1], meta={"architecture": "nnunet3d",
                                           "plan": dict(PLAN, logit_order=order)})
    with pytest.raises(ValueError, match=f"logit_order is {order}.*order 1 only"):
        LMInferer(modelpath=path, device="cpu")


@pytest.mark.parametrize("box,full", [((0, 9, 0, 20, 0, 24), (9, 20, 24)),
                                      ((2, 9, 3, 17, 1, 22), (11, 20, 25))])
def test_plain_export_matches_reference(box, full):
    """Resample, argmax and paste of the same logits; an odd width is not
    packed."""
    lg = np.random.default_rng(4).standard_normal((6, 5, 8, 11)).astype(np.float32)
    packed = export3d.export_reference(torch.from_numpy(lg), box, full).numpy()
    per = export3d.packing(6, full[2])
    got = packed if per == 1 else np.stack([packed & 15, packed >> 4], -1).reshape(full)
    crop = (box[1] - box[0], box[3] - box[2], box[5] - box[4])
    want = ref.export(lg, box, crop, full)
    assert got.shape == want.shape == full
    assert np.mean(got != want) <= 1e-3
    assert export3d.packing(6, 24) == 2 and export3d.packing(6, 25) == 1
    assert export3d.packing(17, 24) == 1


def test_export_bytes_are_counted():
    assert export3d.bytes_moved(6, (192, 239, 239), (192, 512, 512)) == \
        4 * 6 * 192 * 239 * 239 + 192 * 512 * 256


# -- on the card ------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("lshape,box,full", [
    ((6, 24, 30, 30), (0, 40, 0, 64, 0, 64), (40, 64, 64)),
    ((6, 20, 31, 29), (3, 37, 5, 60, 2, 61), (40, 64, 66)),
    ((6, 20, 31, 29), (3, 37, 5, 60, 2, 61), (40, 64, 63)),
    ((17, 9, 12, 13), (0, 10, 1, 20, 0, 30), (12, 21, 30)),
])
def test_export_kernel_matches_plain_version_on_gpu(lshape, box, full):
    dev = tp.cuda_device()
    g = torch.Generator(device=dev).manual_seed(0)
    lg = torch.randn(lshape, generator=g, device=dev)
    before = export3d.export_packed.launches
    got = export3d.export_packed(lg, box, full)
    torch.cuda.synchronize()
    assert export3d.export_packed.launches == before + 1
    want = export3d.export_reference(lg, box, full)
    assert got.shape == want.shape and got.dtype == torch.uint8
    assert (got != want).float().mean().item() <= 1e-5


@pytest.mark.cuda
def test_3d_model_apply_on_gpu_matches_reference(model, image):
    dev = tp.cuda_device()
    path, p = model
    inf = LMInferer(modelpath=path, device=str(dev), precision="float32", tqdm_disable=True,
                    volume_postprocessing=False)
    got = inf.apply(image)
    pre = inf.preprocess_image(image)
    assert np.array_equal(got, inf.finish_forward(pre, inf.forward_preprocessed(pre)))
    assert np.mean(got != _reference_mask(image, p)) <= 1e-3


def test_patch_counter_is_process_wide():
    assert isinstance(sw.PATCHES.value, int)
    before = sw.PATCHES.value
    sw.PATCHES.add(3)
    assert sw.PATCHES.value == before + 3
