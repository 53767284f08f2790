"""The port's engine against ``lungmask_tpu.runtime.engine``: 5 slices at
batch 2 (the last chunk is shorter in the port; JAX pads to whole chunks).

Tolerance: none. At float32 the class maps of the two packages agree on this
input (the logits differ by ~1e-6 against top-2 gaps of ~1e-4), and the
crumb-packed bytes must be equal byte for byte — pixel k at bit offset 2k, as
the JAX host unpack reads them.
"""

import jax.numpy as jnp
import numpy as np
import torch

import torch_parity as tp
from lungmask_tpu.runtime import engine as jeng
from lungmask_tpu_torch.runtime import engine as teng


def test_packed2_bytes_equal_jax_and_unpack_to_volume_argmax():
    params = tp.random_params(n_classes=3, wf=2, seed=1)
    vol = tp.blocky_slices(5, 64, 64, seed=4)[..., 0]
    padded = np.concatenate([vol, np.zeros((1, 64, 64), np.float32)])
    want_packed = np.asarray(
        jeng.volume_argmax_packed2(params, jnp.asarray(padded), 2, jnp.float32)
    )[:5]
    want_dense = np.asarray(jeng.volume_argmax(params, jnp.asarray(padded), 2, jnp.float32))[:5]

    runner = teng.UNetRunner(params, 3, batch_size=2, compute_dtype=torch.float32)
    packed = teng.volume_argmax_packed2(runner.model, torch.from_numpy(vol), 2).numpy()
    assert packed.shape == (5, 64, 16) and packed.dtype == np.uint8
    np.testing.assert_array_equal(packed, want_packed)
    np.testing.assert_array_equal(teng.unpack_crumbs(packed), want_dense)
    np.testing.assert_array_equal(runner.run(torch.from_numpy(vol)).numpy(), want_dense)
    np.testing.assert_array_equal(runner.run_numpy(torch.from_numpy(vol)), want_dense)
    assert len(np.unique(want_dense)) >= 2  # the comparison bites


def test_pack_bits_round_trip_and_policy():
    dense = torch.from_numpy(np.random.default_rng(1).integers(0, 16, (2, 3, 8), dtype=np.uint8))
    for bits in (4, 8):
        packed = teng.pack_bits(dense, bits).numpy()
        np.testing.assert_array_equal(teng.unpack_bits_np(packed, bits), dense.numpy())
        np.testing.assert_array_equal(
            packed, np.asarray(jeng._pack_bits_device(jnp.asarray(dense.numpy()), bits))
        )
    for n_classes, width in [(3, 256), (6, 256), (3, 254), (17, 256), (3, 255)]:
        assert teng.pack_bits_for(n_classes, width) == jeng.pack_bits_for(n_classes, width)
