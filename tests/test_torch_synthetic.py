"""Weights in the port: the numpy crafted parameters, the shape table, the
``.npz`` format and the ``.pth`` conversion, against the JAX package.

Tolerance: none — every array must be equal.
"""

import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from lungmask_tpu.models import convert as jconvert
from lungmask_tpu.models import synthetic as jsyn
from lungmask_tpu.models import unet as junet
from lungmask_tpu_torch.models import convert, synthetic


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_equal(got, want):
    got_l, want_l = _leaves(got), _leaves(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


_INIT_PARAMS = junet.init_params


def _shape_only_init_params(key, **kw):
    """``unet.init_params`` as zeros of its shapes: the JAX ``_scaffold``
    keeps only the shapes (it zeroes every array), and the eager random init
    costs ~20 s of op-by-op compiles on the CPU."""
    shapes = jax.eval_shape(lambda k: _INIT_PARAMS(k, **kw), key)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.mark.parametrize("builder", ["laterality_params", "threshold_params"])
def test_crafted_params_equal_jax(builder):
    with mock.patch.object(junet, "init_params", _shape_only_init_params):
        want = getattr(jsyn, builder)(wf=2)
    _assert_trees_equal(getattr(synthetic, builder)(wf=2), want)


def test_production_shapes_equal_init_params():
    got = synthetic.zero_params(3, wf=6)
    want = jax.eval_shape(lambda k: junet.init_params(k, 3), jax.random.PRNGKey(0))
    got_l, want_l = _leaves(got), _leaves(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    assert [a.shape for _, a in got_l] == [s.shape for _, s in want_l]


def test_npz_round_trip_between_packages(tmp_path):
    params = synthetic.laterality_params(wf=2)
    convert.save_npz(str(tmp_path / "t.npz"), params, meta={"k": 1})
    loaded, meta = jconvert.load_npz(str(tmp_path / "t.npz"))
    _assert_trees_equal(loaded, params)
    assert meta == {"k": 1}
    jconvert.save_npz(str(tmp_path / "j.npz"), params)
    back, _ = convert.load_npz(str(tmp_path / "j.npz"))
    _assert_trees_equal(back, params)


def _state_dict(depth=5, wf=2, n_classes=3, seed=0):
    """Random production-layout (non-residual, upsample) torch state dict."""
    rng = np.random.default_rng(seed)
    chans = [2 ** (wf + i) for i in range(depth)]
    sd = {}

    def conv(prefix, cin, cout, k):
        sd[prefix + ".weight"] = torch.from_numpy(rng.normal(size=(cout, cin, k, k)).astype(np.float32))
        sd[prefix + ".bias"] = torch.from_numpy(rng.normal(size=cout).astype(np.float32))

    def bn(prefix, c):
        sd[prefix + ".weight"] = torch.from_numpy(rng.uniform(0.5, 2, c).astype(np.float32))
        sd[prefix + ".bias"] = torch.from_numpy(rng.normal(size=c).astype(np.float32))
        sd[prefix + ".running_mean"] = torch.from_numpy(rng.normal(size=c).astype(np.float32))
        sd[prefix + ".running_var"] = torch.from_numpy(rng.uniform(0.1, 3, c).astype(np.float32))

    def block(prefix, cin, cout):
        conv(prefix + ".block.0", cin, cout, 3)
        bn(prefix + ".block.2", cout)
        conv(prefix + ".block.3", cout, cout, 3)
        bn(prefix + ".block.5", cout)

    prev = 1
    for i, c in enumerate(chans):
        block(f"down_path.{i}", prev, c)
        prev = c
    for j, i in enumerate(reversed(range(depth - 1))):
        conv(f"up_path.{j}.up.1", prev, chans[i], 1)
        block(f"up_path.{j}.conv_block", 2 * chans[i], chans[i])
        prev = chans[i]
    conv("last", prev, n_classes, 1)
    return sd


def test_pth_conversion_equals_jax(tmp_path):
    path = str(tmp_path / "m.pth")
    torch.save(_state_dict(), path)
    got, n = convert.convert_pth(path)
    want, n_want = jconvert.convert_pth(path)
    assert n == n_want == 3
    _assert_trees_equal(got, want)
    sd = {k: v for k, v in _state_dict().items() if ".block.2." not in k}
    for conv_ in (convert, jconvert):  # a batch_norm=False layout
        with pytest.raises(NotImplementedError, match="batch_norm=False"):
            conv_.convert_state_dict(sd)


def test_registry_reads_the_jax_cache_and_never_downloads(tmp_path, monkeypatch):
    """With nothing cached the port tries the release URL (here a
    ``file://`` URL of an absent file) and raises as JAX does; with the JAX
    package's ``.npz`` in the cache it reads that and fetches nothing."""
    from lungmask_tpu.models import registry as jregistry
    from lungmask_tpu_torch.models import registry

    monkeypatch.setenv("LUNGMASK_TPU_CACHE", str(tmp_path))
    absent = (tmp_path / "release" / "unet_r231-d5d2fc3d.pth").as_uri()
    monkeypatch.setitem(registry.MODEL_URLS, "R231", (absent, 3))
    monkeypatch.setitem(jregistry.MODEL_URLS, "R231", (absent, 3))
    with pytest.raises(RuntimeError, match="could not be downloaded"):
        registry.get_model("R231")

    def no_fetch(url, dest):
        raise AssertionError(f"fetched {url}")

    monkeypatch.setattr(registry, "_download", no_fetch)
    params = synthetic.laterality_params(wf=2)
    jconvert.save_npz(jregistry._npz_cache_path("R231"), params)
    got, n = registry.get_model("R231")
    assert n == 3
    _assert_trees_equal(got, params)
