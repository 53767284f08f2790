"""The port's U-Net against ``lungmask_tpu.models.unet`` on the same weights.

Weights: the tree of ``unet.init_params`` (its shapes, via ``eval_shape``)
filled from a numpy seed — conv weights and biases U(−1/√fan_in, 1/√fan_in)
as torch's default init, folded-BN affines random around identity.

Tolerances (narrow net, wf=2):
* float32: logits within atol = rtol = 1e-4 of JAX's HIGHEST-precision
  logits (both accumulate in float32 in different orders; the measured
  difference is ~1e-6), and an identical argmax (the smallest top-2 logit
  gap on these inputs is ~1e-4).
* bfloat16: each conv stage is K4's plain version on the CPU (a float32
  accumulator through the bias, ReLU and affine, one rounding), as JAX's.
  Against JAX bf16 as it runs on the CPU: at least 99.8% argmax agreement
  (99.84% measured) and logits within 0.05 (0.0465 measured; torch's bf16
  conv before K4: 0.0546): what still differs is JAX's pooling and
  upsampling, which XLA rounds to bf16 at each step where K2 and K3 (and the
  JAX package's own Pallas kernels) round once. With those two swapped for
  the JAX package's Pallas kernels (interpret mode), the logits are JAX's
  to 1e-6 of the largest and the argmax identical (measured: equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from lungmask_tpu.models import unet as junet
from lungmask_tpu_torch.models import convert, unet

WF = 2


@pytest.fixture(scope="module")
def params():
    return tp.random_params(n_classes=3, wf=WF, seed=1)


def _inputs(n, h, w, seed=0):
    return tp.blocky_slices(n, h, w, seed)


def _jax_logits(params, x, dtype):
    return np.asarray(junet.unet_logits(params, jnp.asarray(x), compute_dtype=dtype))


@pytest.mark.parametrize("hw", [(64, 64), (66, 70)])  # (66, 70) needs _center_crop
def test_float32_logits_match(params, hw):
    x = _inputs(2, *hw)
    want = _jax_logits(params, x, jnp.float32)
    model = unet.UNet(convert.from_jax_params(params), torch.float32)
    with torch.inference_mode():
        got = unet.unet_logits(model, torch.from_numpy(x)).numpy()
        am = unet.unet_argmax(model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(am, want.argmax(-1))
    assert am.dtype == np.uint8
    assert len(np.unique(am)) >= 2  # the argmax check bites


def test_bfloat16_argmax_agreement(params, monkeypatch):
    from lungmask_tpu.ops.pallas import stencil as jst

    x = _inputs(2, 64, 64, seed=1)
    want = _jax_logits(params, x, jnp.bfloat16)
    model = unet.UNet(convert.from_jax_params(params), torch.bfloat16)
    with torch.inference_mode():
        logits = unet.unet_logits(model, torch.from_numpy(x)).numpy()
        got = unet.unet_argmax(model, torch.from_numpy(x)).numpy()
    assert model.wl.dtype == torch.bfloat16 and model.down[0].b1.dtype == torch.float32
    np.testing.assert_array_equal(got, logits.argmax(-1))
    assert (got == want.argmax(-1)).mean() >= 0.998
    assert np.abs(logits - want).max() <= 0.05
    # JAX with its stencils as its Pallas kernels compute them (one rounding).
    monkeypatch.setattr(junet, "_avg_pool2", lambda v: jst.avg_pool2_pallas(v, interpret=True))
    monkeypatch.setattr(junet, "_bilinear_up2",
                        lambda v: jst.bilinear_up2_pallas(v, interpret=True))
    once = _jax_logits(params, x, jnp.bfloat16)
    np.testing.assert_allclose(logits, once, rtol=0, atol=1e-6 * np.abs(once).max())
    np.testing.assert_array_equal(got, once.argmax(-1))


def test_from_jax_params_layout(params):
    tp = convert.from_jax_params(params)
    w = params["down"][1]["conv1"]["w"]  # HWIO
    assert tuple(tp["down"][1]["conv1"]["w"].shape) == (w.shape[3], w.shape[2], 3, 3)
    np.testing.assert_array_equal(tp["down"][1]["conv1"]["w"].numpy()[5, 2], w[:, :, 2, 5])
    assert unet.n_classes_of(tp) == junet.n_classes_of(params) == 3


def test_variants_wait(params):
    """The variants dispatch on the tree's keys (``tests/test_torch_variants.py``
    holds them against JAX): an up block with ``upconv`` in place of
    ``proj`` takes the transposed conv, whose (2, 2, in, out) kernel the
    port holds as (out, in, 2, 2)."""
    cin, cout = params["up"][0]["proj"]["w"].shape[2:]
    upconv = {"w": np.ones((2, 2, cin, cout), np.float32), "b": np.zeros(cout, np.float32)}
    first = {k: v for k, v in params["up"][0].items() if k != "proj"}
    tree = dict(params, up=[dict(first, upconv=upconv)] + params["up"][1:])
    model = unet.UNet(convert.from_jax_params(tree))
    assert model.up[0].upconv and not model.up[1].upconv
    assert tuple(model.up[0].wp.shape) == (cout, cin, 2, 2)
    assert sorted(model.tree()["up"][0]) == ["conv_block", "upconv"]
