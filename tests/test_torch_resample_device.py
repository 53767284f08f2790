"""The device half of the port's ``ops/resample.py`` (``resize``,
``crop_resize_plan``, ``apply_crop_resize``) against the JAX package's.

Tolerances: order 0 (nearest) bit-equal, the plans' arrays equal; order 1
(linear, float32) within 1e-6 absolute on inputs in [0, 1), 1e-6 of the
largest value on HU inputs — the same products and sums, in an order XLA
may fuse differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from lungmask_tpu.ops import resample as jres
from lungmask_tpu_torch.ops import resample

# (in, out) pairs per axis; 128 → 91 zero-fills its last sample (scipy's
# float64 coordinate lands past the edge), 512 → 128 and 7 → 1 subsample.
SHAPE_PAIRS = [((128, 128), (91, 91)), ((64, 80), (128, 91)), ((512, 300), (128, 128)),
               ((7, 33), (1, 200)), ((37, 5), (256, 256))]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return {
        "float32": rng.random((3,) + shape, dtype=np.float32),
        "int16": rng.integers(-1024, 600, (3,) + shape).astype(np.int16),
        "bool": rng.random((3,) + shape) < 0.5,
    }


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("pair", SHAPE_PAIRS)
def test_resize_equals_jax(pair, order):
    src, dst = pair
    assert resample._axis_plan_np(128, 91, 0)[1][-1]  # the quirk is exercised
    for name, x in _inputs(src, sum(src)).items():
        if order == 1 and name == "bool":
            continue
        got = resample.resize(torch.from_numpy(x), (3,) + dst, order).numpy()
        want = np.asarray(jres.resize(jnp.asarray(x), (3,) + dst, order))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if order == 0:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(1, np.abs(want).max()),
                                       err_msg=name)


def _boxes(seed, n, h, w):
    rng = np.random.default_rng(seed)
    r0 = rng.integers(0, h - 1, n)
    c0 = rng.integers(0, w - 1, n)
    r1 = r0 + 1 + rng.integers(0, h - r0)
    c1 = c0 + 1 + rng.integers(0, w - c0)
    boxes = np.stack([r0, c0, r1, c1], 1)
    boxes[0] = (0, 0, h, w)
    boxes[1] = (10, 20, 10 + 128, 20 + 128)  # a 128² crop to 91²: the quirk
    return boxes.astype(np.int32)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("out_shape", [(256, 256), (91, 91), (64, 48)])
def test_crop_resize_plan_and_apply_equal_jax(order, out_shape):
    n, h, w = 6, 160, 150
    boxes = _boxes(order * 7 + out_shape[1], n, h, w)
    tplan = resample.crop_resize_plan(boxes, out_shape, order, device="cpu")
    jplan = jres.crop_resize_plan(boxes, out_shape, order)
    assert sorted(tplan) == sorted(jplan)
    for key in tplan:
        got, want = tplan[key].numpy(), np.asarray(jplan[key])
        # Indices widen from JAX's int32 to int64 for torch's gathers.
        assert got.dtype == (np.int64 if want.dtype == np.int32 else want.dtype), key
        np.testing.assert_array_equal(got, want, err_msg=key)
    rng = np.random.default_rng(order)
    imgs = {"float32": rng.random((n, h, w), dtype=np.float32),
            "int32": rng.integers(0, 3, (n, h, w)).astype(np.int32)}
    for name, x in imgs.items():
        got = resample.apply_crop_resize(torch.from_numpy(x), tplan).numpy()
        want = np.asarray(jres.apply_crop_resize(jnp.asarray(x), jplan))
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        if order == 0:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(1, np.abs(want).max()),
                                       err_msg=name)
