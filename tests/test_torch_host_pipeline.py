"""The strict host preprocessing of the port against the JAX package's, and
the fault it repairs: volumes of slices under 128², which the port's hybrid
preprocessing used to refuse, now take the host pipeline as JAX's do.

Tolerance: none. The host chain is the same float64 scipy arithmetic on
both sides, so slices, boxes, the normalized stack (float32 and its bf16
rounding) and the final masks must be equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
import lungmask_tpu
from lungmask_tpu.transforms import host_pipeline as jhost
from lungmask_tpu.transforms import preprocess as jpre
from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.models import convert, synthetic
from lungmask_tpu_torch.transforms import host_pipeline, preprocess

F32 = dict(precision="float32", tqdm_disable=True, batch_size=2)


def _volume(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """A body with two lungs and a border blob, an empty slice, and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    vol = np.full((n, h, w), -1000, np.int16)
    body = ((yy - h / 2) / (h * 0.40)) ** 2 + ((xx - w / 2) / (w * 0.35)) ** 2 < 1
    lungs = ((yy - h / 2) / (h * 0.2)) ** 2 + ((np.abs(xx - w / 2) - w * 0.15) / (w * 0.1)) ** 2 < 1
    vol[0][body] = 40
    vol[0][lungs] = -850
    vol[0, : max(1, h // 10), w // 10 : w // 5] = 100
    vol[2:] = rng.integers(-1100, 100, (n - 2, h, w))
    return vol


@pytest.mark.parametrize("shape", [(64, 64), (40, 90), (100, 200), (200, 150)])
def test_host_pipeline_equals_jax(shape):
    vol = _volume(3, *shape, seed=shape[0])
    slices, boxes = host_pipeline.preprocess(vol, resolution=(256, 256))
    want_slices, want_boxes = jhost.preprocess(vol, resolution=(256, 256))
    np.testing.assert_array_equal(slices, want_slices)
    np.testing.assert_array_equal(np.asarray(boxes), np.asarray(want_boxes))
    np.testing.assert_array_equal(host_pipeline.normalize_hu(slices), jhost.normalize_hu(want_slices))
    mask = host_pipeline.body_mask_slice(vol[0])
    np.testing.assert_array_equal(mask, jhost.body_mask_slice(vol[0]))
    box = np.asarray(boxes[0])
    np.testing.assert_array_equal(
        host_pipeline.restore_mask_geometry(mask[:10, :10].astype(np.uint8), box, shape),
        jhost.restore_mask_geometry(mask[:10, :10].astype(np.uint8), box, shape),
    )


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", [(64, 64), (150, 170)])
def test_preprocess_host_equals_jax(shape, bf16):
    """``preprocessing="host"`` (and the small-slice fallback of hybrid):
    the stack JAX's host mode uploads, rounded to the compute dtype."""
    vol = _volume(3, *shape, seed=1)
    dtype = torch.bfloat16 if bf16 else torch.float32
    got, boxes = preprocess.preprocess_host(vol, compute_dtype=dtype, device="cpu")
    slices, want_boxes = jhost.preprocess(vol, resolution=(256, 256))
    want = jhost.normalize_hu(slices).astype(np.float32)
    if bf16:
        want = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == dtype and got.shape == (3, 256, 256)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(boxes, np.asarray(want_boxes))
    if min(shape) < 128:
        hyb, hyb_boxes = preprocess.preprocess_hybrid(vol, compute_dtype=dtype, device="cpu")
        jhyb, jhyb_boxes = jpre.preprocess_hybrid(vol, compute_dtype=jnp.bfloat16 if bf16 else None)
        np.testing.assert_array_equal(hyb.float().numpy(), np.asarray(jhyb, np.float32))
        np.testing.assert_array_equal(hyb_boxes, jhyb_boxes)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "laterality_wf2.npz")
    convert.save_npz(path, synthetic.laterality_params(wf=2))
    return path


def test_small_volume_apply_equals_jax(weights):
    """The fault: a 64×64 volume raised NotImplementedError in the port's
    hybrid preprocessing; now its mask equals JAX's voxel for voxel."""
    vol = synthetic.lung_phantom(4, size=64)
    got = LMInferer(modelpath=weights, device="cpu", **F32).apply(vol)
    want = lungmask_tpu.LMInferer(modelpath=weights, **F32).apply(vol)
    assert got.shape == vol.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2}


def test_host_mode_apply_equals_jax_and_hybrid(weights):
    vol = synthetic.lung_phantom(3, size=160)
    port = LMInferer(modelpath=weights, device="cpu", preprocessing="host", **F32)
    assert port.preprocessing == "host"
    got = port.apply(vol)
    want = lungmask_tpu.LMInferer(modelpath=weights, preprocessing="host", **F32).apply(vol)
    np.testing.assert_array_equal(got, want)
    hybrid = LMInferer(modelpath=weights, device="cpu", **F32).apply(vol)
    np.testing.assert_array_equal(got, hybrid)


def test_unknown_preprocessing_raises(weights):
    with pytest.raises(ValueError, match="unknown preprocessing"):
        LMInferer(modelpath=weights, device="cpu", preprocessing="gpu")
