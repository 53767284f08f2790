"""Hybrid preprocessing of the port against the JAX package.

Tolerance: none. Packed bits, boxes and the normalized float32 stack (the
same float64 host arithmetic on both sides) must be equal bit for bit; the
bf16 stack too, since both round the same float32 values to nearest even.
JAX runs its XLA bodymask path (``use_pallas=False``), which
tests/test_pallas.py proves equal to the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from lungmask_tpu.transforms import preprocess as jpre
from lungmask_tpu_torch.ops import cc, resample
from lungmask_tpu_torch.ops.kernels.bodymask import bodymask_labels
from lungmask_tpu_torch.transforms import preprocess as tpre

SHAPES = [(512, 512), (300, 200), (129, 255)]


def _volume(h: int, w: int) -> np.ndarray:
    """Four int16 slices: a body with lungs and a losing blob, an empty
    slice, two equal-area bodies (a largest-component tie), and noise."""
    rng = np.random.default_rng(h * 1000 + w)
    yy, xx = np.mgrid[0:h, 0:w]
    vol = np.full((4, h, w), -1000, np.int16)
    body = ((yy - h / 2) / (h * 0.40)) ** 2 + ((xx - w / 2) / (w * 0.35)) ** 2 < 1
    lungs = ((yy - h / 2) / (h * 0.2)) ** 2 + ((np.abs(xx - w / 2) - w * 0.15) / (w * 0.1)) ** 2 < 1
    vol[0][body] = 40
    vol[0][lungs] = -850
    vol[0, : h // 10, w // 10 : w // 5] = 100
    # Two equal squares drawn on the pixels the 128² subsample reads, so the
    # bodymask sees two translates of one square: an exact area tie.
    ridx, _ = resample._axis_plan_np(h, 128, 0)
    cidx, _ = resample._axis_plan_np(w, 128, 0)
    for c0 in (20, 70):
        vol[2][np.ix_(ridx[40:80], cidx[c0 : c0 + 30])] = 40
    vol[3] = rng.integers(-1100, 100, (h, w))
    vol[0] += rng.integers(-30, 30, (h, w)).astype(np.int16)
    return vol


def _jax_boxes(vol: np.ndarray) -> np.ndarray:
    n, h, w = vol.shape
    packed = jpre.pack_bodymask_bits(vol)
    pad = np.zeros((jpre.pad_slices(n) - n,) + packed.shape[1:], np.uint8)
    padded = np.concatenate([packed, pad])
    return np.asarray(jpre._boxes_from_packed(jnp.asarray(padded), (h, w), False))[:n]


@pytest.mark.parametrize("shape", SHAPES + [(517, 130)])
def test_pack_bodymask_bits_bytes_equal(shape):
    vol = _volume(*shape)
    got = tpre.pack_bodymask_bits(vol)
    assert got.dtype == np.uint8 and got.shape == (4, 128, 16)
    np.testing.assert_array_equal(got, jpre.pack_bodymask_bits(vol))


@pytest.mark.parametrize("shape", SHAPES)
def test_boxes_from_packed_equal(shape):
    vol = _volume(*shape)
    packed = torch.from_numpy(tpre.pack_bodymask_bits(vol))
    got = tpre._boxes_from_packed(packed, shape).numpy()
    want = _jax_boxes(vol)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[1], [0, 0, shape[0], shape[1]])  # empty


@pytest.mark.parametrize("shape", SHAPES)
def test_boxes_tie_takes_first_component(shape):
    """The tie slice has two components of equal area at 128², and its box
    is the left (scan-order-first) square's."""
    vol = _volume(*shape)
    packed = torch.from_numpy(tpre.pack_bodymask_bits(vol))
    labels, _ = bodymask_labels(tpre.smalls_from_packed(packed)[2:3])
    areas = cc.areas_by_root(labels)[0, 1:]
    sizes = areas[areas > 0].tolist()
    assert len(sizes) == 2 and sizes[0] == sizes[1]
    r0, c0, r1, c1 = tpre._boxes_from_packed(packed, shape)[2].tolist()
    assert c1 <= shape[1] // 2 < int(resample._axis_plan_np(shape[1], 128, 0)[0][70])


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float32])
def test_crop_resize_normalize_host_equal(dtype):
    rng = np.random.default_rng(5)
    vol = rng.integers(-1200, 900, (3, 150, 170)).astype(dtype)
    if dtype == np.float32:
        vol += 0.25  # float volumes take the scipy path on both sides
    boxes = np.asarray([[0, 0, 150, 170], [10, 20, 100, 169], [3, 4, 5, 9]], np.int32)
    got = tpre.crop_resize_normalize_host(vol, boxes, (256, 256))
    want = jpre.crop_resize_normalize_host(vol, boxes, (256, 256))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bf16", [False, True])
def test_preprocess_hybrid_equal(bf16):
    vol = _volume(512, 512)
    got, boxes = tpre.preprocess_hybrid(
        vol, compute_dtype=torch.bfloat16 if bf16 else torch.float32, device="cpu"
    )
    want, want_boxes = jpre.preprocess_hybrid(
        vol, compute_dtype=jnp.bfloat16 if bf16 else None
    )
    np.testing.assert_array_equal(boxes, want_boxes)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_small_slices_wait_for_host_pipeline():
    """Slices under 128² take the strict host pipeline, as JAX's fallback
    does: the same boxes and the same normalized stack, bit for bit."""
    vol = _volume(100, 200)
    got, boxes = tpre.preprocess_hybrid(vol, compute_dtype=torch.float32, device="cpu")
    want, want_boxes = jpre.preprocess_hybrid(vol)
    np.testing.assert_array_equal(boxes, want_boxes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    host, host_boxes = tpre.preprocess_host(vol, compute_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(host.numpy(), got.numpy())
    np.testing.assert_array_equal(host_boxes, boxes)
