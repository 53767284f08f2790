"""The U-Net variants in the port (``residual``, ``upconv`` and both) against
the JAX package, from reference-layout state dicts made from a seed
(``models/synthetic.reference_state_dict``) at narrow widths, on the CPU.

Tolerances:
* conversion: none — both packages' ``detect_config`` and
  ``convert_state_dict`` give the same keys and equal arrays;
* float32 logits: atol = rtol = 1e-4 of JAX's HIGHEST-precision logits,
  with an identical argmax (as ``tests/test_torch_unet.py``);
* one float32 train step: the loss within 1e-5 relative, every gradient
  leaf within 1e-4 of that leaf's largest gradient and none all zero (as
  ``tests/test_torch_train.py``);
* ``LMInferer`` at float32: the mask equal to JAX's voxel for voxel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from lungmask_tpu.models import convert as jconvert
from lungmask_tpu.models import unet as junet
from lungmask_tpu.train import trainer as jtrainer
from lungmask_tpu_torch.models import convert, synthetic, unet
from lungmask_tpu_torch.train import cross_entropy_loss, dice_loss

VARIANTS = {  # name: (residual, up_mode)
    "residual": (True, "upsample"),
    "upconv": (False, "upconv"),
    "residual+upconv": (True, "upconv"),
}


def _state_dict(variant, depth=4, wf=2, seed=0, n_classes=3):
    residual, up_mode = VARIANTS[variant]
    return synthetic.reference_state_dict(n_classes, depth=depth, wf=wf, residual=residual,
                                          up_mode=up_mode, seed=seed)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, a in got.items():
        assert a.dtype == want[path].dtype, path
        np.testing.assert_array_equal(a, want[path], err_msg=str(path))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_detect_and_convert_equal_jax(variant):
    sd = _state_dict(variant, depth=5)
    cfg = convert.detect_config(sd)
    assert cfg == jconvert.detect_config(sd)
    assert (cfg["residual"], cfg["up_mode"]) == VARIANTS[variant] and cfg["depth"] == 5
    got, want = convert.convert_state_dict(sd), jconvert.convert_state_dict(sd)
    _assert_trees_equal(got, want)
    keys = {k for path, _ in _leaves(got) for k in path if isinstance(k, str)}
    assert ("res" in keys) == cfg["residual"] and ("bn_pre" in keys) == cfg["residual"]
    assert ("upconv" in keys) == (cfg["up_mode"] == "upconv") and ("proj" in keys) != ("upconv" in keys)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_npz_and_pth_round_trips_keep_the_variant(variant, tmp_path):
    """The variant keys survive both packages' ``.npz`` format and the
    port's tree (``from_jax_params`` → ``UNet.tree`` → ``to_jax_params``);
    a ``.pth`` of the state dict converts as the dict does."""
    sd = _state_dict(variant, depth=3, seed=4)
    params = convert.convert_state_dict(sd)
    convert.save_npz(str(tmp_path / "p.npz"), params, meta={"variant": variant})
    back, meta = jconvert.load_npz(str(tmp_path / "p.npz"))
    assert meta == {"variant": variant}
    _assert_trees_equal(back, params)
    _assert_trees_equal(convert.unflatten_params(convert.flatten_params(params)), params)
    for trainable in (False, True):
        model = unet.UNet(convert.from_jax_params(params), torch.float32, trainable=trainable)
        _assert_trees_equal(convert.to_jax_params(model.tree()), params)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(tmp_path / "m.pth"))
    got, n = convert.convert_pth(str(tmp_path / "m.pth"))
    assert n == 3
    _assert_trees_equal(got, params)


# Seeds whose random nets give more than one class on these inputs (most
# random nets give one class everywhere), so that the argmax check bites.
@pytest.mark.parametrize("variant, depth, wf, seed", [("residual", 3, 3, 5), ("upconv", 4, 2, 11),
                                                      ("residual+upconv", 5, 2, 3)])
@pytest.mark.parametrize("hw", [48, 50])  # 50 is odd after one pool: _center_crop
def test_float32_logits_equal_jax(variant, depth, wf, seed, hw):
    params = jconvert.convert_state_dict(_state_dict(variant, depth=depth, wf=wf, seed=seed))
    x = tp.blocky_slices(2, hw, hw, seed=2)
    want = np.asarray(junet.unet_logits(params, jnp.asarray(x), compute_dtype=jnp.float32))
    model = unet.UNet(convert.from_jax_params(params), torch.float32)
    with torch.inference_mode():
        got = unet.unet_logits(model, torch.from_numpy(x)).numpy()
    # An odd level drops a row and column in the pool: 50² comes out 48².
    assert got.shape == want.shape == (2, 48, 48, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert len(np.unique(want.argmax(-1))) >= 2  # the argmax check bites


def test_bfloat16_argmax_tracks_jax():
    """bf16 rounds in other places in the two frameworks: argmax agreement."""
    params = jconvert.convert_state_dict(_state_dict("residual+upconv", seed=3))
    x = tp.blocky_slices(2, 48, 48, seed=3)
    want = np.asarray(junet.unet_argmax(params, jnp.asarray(x), compute_dtype=jnp.bfloat16))
    model = unet.UNet(convert.from_jax_params(params), torch.bfloat16)
    with torch.inference_mode():
        got = unet.unet_argmax(model, torch.from_numpy(x)).numpy()
    assert (got == want).mean() >= 0.98


def test_f32_train_step_gradients_equal_jax():
    """One float32 step of the residual+upconv net: the loss and every
    gradient leaf — the ``res``, ``bn_pre`` and ``upconv`` leaves
    included — against ``jax.value_and_grad``."""
    params = jconvert.convert_state_dict(_state_dict("residual+upconv", depth=3, seed=10))
    images = tp.blocky_slices(2, 48, 48, seed=5)
    labels = np.random.default_rng(5).integers(0, 3, (2, 48, 48)).astype(np.int32)
    labels[:, 12:36, 10:30] = 1

    def jloss(p, x, y):
        logits = junet.unet_logits(p, x, compute_dtype=jnp.float32)
        return 0.5 * jtrainer.cross_entropy_loss(logits, y) + 0.5 * jtrainer.dice_loss(logits, y)

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(params, jnp.asarray(images),
                                                     jnp.asarray(labels))
    model = unet.UNet(convert.from_jax_params(params), torch.float32, trainable=True)
    logits = model.logits(torch.from_numpy(images), torch.float32)
    y = torch.from_numpy(labels)
    loss = 0.5 * cross_entropy_loss(logits, y) + 0.5 * dice_loss(logits, y)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    got = dict(_leaves(convert.to_jax_params(
        model.tree({k: p.grad for k, p in model.named_parameters()}))))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert sorted(got) == sorted(want)
    assert any("res" in p for p in got) and any("upconv" in p for p in got)
    assert any("bn_pre" in p for p in got)
    for path, g in got.items():
        scale = np.abs(want[path]).max()
        assert scale > 0 and np.abs(g).max() > 0, f"{path}: an all-zero gradient"
        np.testing.assert_allclose(g, want[path], rtol=0, atol=1e-4 * scale, err_msg=str(path))


def _volume(n=3, hw=64, seed=0):
    """A body with two lungs and noise, int16 HU (host preprocessing below 128²)."""
    rng = np.random.default_rng(seed)
    vol = np.full((n, hw, hw), -1000, dtype=np.int16)
    yy, xx = np.mgrid[0:hw, 0:hw]
    body = ((yy - hw / 2) / (hw * 0.4)) ** 2 + ((xx - hw / 2) / (hw * 0.35)) ** 2 < 1
    for i in range(n):
        vol[i][body] = 40
        for cx in (0.35, 0.65):
            lung = ((yy - hw / 2) / (hw * 0.2)) ** 2 + ((xx - hw * cx) / (hw * 0.1)) ** 2 < 1
            vol[i][lung] = -850
    return (vol + rng.integers(-40, 40, vol.shape)).astype(np.int16)


@pytest.mark.parametrize("ext", [".pth", ".npz"])
def test_inferer_with_a_variant_checkpoint_equals_jax(ext, tmp_path):
    """``LMInferer(modelpath=<residual+upconv checkpoint>)`` in both
    packages, float32, raw predictions pasted back (the postprocessing of
    both is held equal elsewhere) and with the default postprocessing."""
    import lungmask_tpu

    from lungmask_tpu_torch import LMInferer

    sd = _state_dict("residual+upconv", depth=4, seed=3)
    path = str(tmp_path / f"variant{ext}")
    if ext == ".pth":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    else:
        convert.save_npz(path, convert.convert_state_dict(sd))
    vol = _volume()
    for post in (False, True):
        kw = dict(modelpath=path, force_cpu=True, tqdm_disable=True, precision="float32",
                  volume_postprocessing=post)
        got = LMInferer(**kw).apply(vol)
        want = lungmask_tpu.LMInferer(**kw).apply(vol)
        assert got.shape == vol.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        if not post:
            assert len(np.unique(got)) >= 2
