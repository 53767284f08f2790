"""Device preprocessing of the port (``transforms/preprocess.preprocess``,
``compute_boxes``, ``LMInferer(preprocessing="device")``) against the JAX
package's.

At 64² the boxes come from the full-resolution branch (order-0 resize to
the slice, 8-connected labels per plane), at 160² from the 128-grid branch;
both for int16 and float64 volumes (JAX computes the latter in float32, and
so does the port). JAX runs its XLA bodymask path, which
tests/test_pallas.py proves equal to the Pallas kernel.

Tolerances:
* boxes: none, and at 160² equal to the hybrid boxes;
* the normalized float32 stack: 1e-6 absolute, except where an integer
  volume's interpolated HU lands within float32 rounding of a half-integer,
  so that the two packages' sums round it (``_round_half_away``) to
  neighbouring integers — a step of 1/1624; at most 0.01% of the elements;
* masks of ``LMInferer`` at float32: none, with exact and with device
  postprocessing.
"""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
import lungmask_tpu
from lungmask_tpu.transforms import preprocess as jpre
from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.models import convert, synthetic
from lungmask_tpu_torch.transforms import preprocess as tpre

STEP = 1 / 1624  # one HU after normalization
MAX_FLIPPED = 1e-4


def _volume(size: int, dtype) -> np.ndarray:
    """Three phantom slices, an empty slice and a noise slice; float volumes
    get fractional HU."""
    rng = np.random.default_rng(size)
    vol = synthetic.lung_phantom(5, size=size).astype(np.float64)
    vol[3] = -1024
    vol[4] = rng.integers(-1100, 100, (size, size))
    if dtype == np.float64:
        vol += rng.random(vol.shape) - 0.5
    return vol.astype(dtype)


@pytest.mark.parametrize("dtype", [np.int16, np.float64])
@pytest.mark.parametrize("size", [64, 160])
def test_preprocess_equals_jax(size, dtype):
    vol = _volume(size, dtype)
    normalized, boxes = tpre.preprocess(vol, resolution=(256, 256), device="cpu")
    jnorm, jboxes = jpre.preprocess(vol, resolution=(256, 256))
    jnorm = np.asarray(jnorm)[: len(vol)]
    assert boxes.dtype == np.int32 and boxes.shape == (len(vol), 4)
    np.testing.assert_array_equal(boxes, np.asarray(jboxes))
    np.testing.assert_array_equal(tpre.compute_boxes(vol, device="cpu"), boxes)
    np.testing.assert_array_equal(boxes, np.asarray(jpre.compute_boxes(vol)))
    assert (boxes[3] == (0, 0, size, size)).all()  # the empty slice boxes the full slice
    if size >= 128:
        np.testing.assert_array_equal(boxes, tpre.preprocess_hybrid(vol, device="cpu")[1])
    got = normalized.numpy()
    assert got.dtype == np.float32 and got.shape == jnorm.shape == (len(vol), 256, 256)
    diff = np.abs(got - jnorm)
    flipped = diff > 1e-6
    if dtype == np.float64:
        assert not flipped.any(), diff.max()
    else:
        assert flipped.mean() <= MAX_FLIPPED, flipped.sum()
        np.testing.assert_allclose(diff[flipped], STEP, rtol=1e-3)


def test_compute_dtype_is_one_cast():
    import torch

    vol = _volume(64, np.int16)
    f32, _ = tpre.preprocess(vol, device="cpu")
    bf16, _ = tpre.preprocess(vol, compute_dtype=torch.bfloat16, device="cpu")
    assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, f32.to(torch.bfloat16))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "laterality_wf2.npz")
    convert.save_npz(path, synthetic.laterality_params(wf=2))
    return path


@pytest.mark.parametrize("mode", ["exact", "device"])
def test_device_mode_apply_equals_jax(weights, mode):
    vol = synthetic.lung_phantom(4, size=160)
    kw = dict(modelpath=weights, precision="float32", tqdm_disable=True, batch_size=2,
              preprocessing="device", postprocessing_mode=mode)
    port = LMInferer(device="cpu", **kw)
    got = port.apply(vol)
    want = lungmask_tpu.LMInferer(**kw).apply(vol)
    assert got.dtype == np.uint8 and got.shape == vol.shape
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2}
    pre = port.preprocess_image(vol)
    assert pre["normalized"].shape == (4, 256, 256)
    np.testing.assert_array_equal(pre["boxes"], tpre.preprocess_hybrid(vol, device="cpu")[1])


def test_device_mode_small_slices_take_the_full_resolution_branch(weights):
    """Slices under 128² stay on the device path (hybrid mode would take the
    host pipeline) and give JAX's device-mode mask."""
    vol = synthetic.lung_phantom(3, size=96)
    kw = dict(modelpath=weights, precision="float32", tqdm_disable=True,
              preprocessing="device")
    got = LMInferer(device="cpu", **kw).apply(vol)
    np.testing.assert_array_equal(got, lungmask_tpu.LMInferer(**kw).apply(vol))
    assert set(np.unique(got)) == {0, 1, 2}
    np.testing.assert_array_equal(tpre.compute_boxes(vol, device="cpu"),
                                  np.asarray(jpre.compute_boxes(vol)))
