"""The port's weight store against the JAX package's, on one cache.

Every case of ``tests/test_registry.py`` runs through both packages'
``get_model`` on the same ``$LUNGMASK_TPU_CACHE``: both raise the same
error, or both load the same arrays. A release checkpoint is fetched by
each package from a ``file://`` URL (a ``.pth`` written on the spot and
named after its own sha256 prefix), and each package reads the cache the
other wrote without fetching again.

No test reaches the network: every entry of both packages' ``MODEL_URLS``
points at a ``file://`` URL under the test's directory.

Tolerance: none. Weights, ``.npz`` meta and masks compare bit for bit.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from lungmask_tpu.models import convert as jconvert
from lungmask_tpu.models import registry as jregistry
from lungmask_tpu_torch.models import convert, registry, synthetic

PACKAGES = {"jax": jregistry, "torch": registry}
N_CLASSES = 3


def _assert_same(a, b):
    fa, fb = jconvert.flatten_params(a), jconvert.flatten_params(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(autouse=True)
def offline_urls(tmp_path, monkeypatch):
    """Both packages' release URLs → ``file://<tmp>/release/<release file>``
    (absent until a test writes it)."""
    release = tmp_path / "release"
    release.mkdir()
    for reg in PACKAGES.values():
        for name, (url, n) in list(reg.MODEL_URLS.items()):
            local = (release / os.path.basename(url)).as_uri()
            monkeypatch.setitem(reg.MODEL_URLS, name, (local, n))
    return release


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    path = tmp_path / "cache"  # not made: cache_dir() creates it
    monkeypatch.setenv("LUNGMASK_TPU_CACHE", str(path))
    return path


@pytest.fixture(scope="module")
def state_dict():
    """A depth-3, wf=2 reference-layout state dict as torch tensors (what
    ``torch.load(..., weights_only=True)`` accepts)."""
    sd = synthetic.reference_state_dict(N_CLASSES, depth=3, wf=2, seed=4)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _write_release(state_dict, directory) -> str:
    """``torch.save`` the state dict as ``unet_r231-<its sha256 prefix>.pth``
    in ``directory``; returns the path."""
    tmp = os.path.join(directory, "unet_r231.pth")
    torch.save(state_dict, tmp)
    with open(tmp, "rb") as f:
        prefix = hashlib.sha256(f.read()).hexdigest()[:8]
    path = os.path.join(directory, f"unet_r231-{prefix}.pth")
    os.replace(tmp, path)
    return path


def _point_r231_at(path, monkeypatch):
    for reg in PACKAGES.values():
        monkeypatch.setitem(reg.MODEL_URLS, "R231", ("file://" + path, N_CLASSES))


def _outcome(reg, name="R231"):
    """("ok", params, n) or ("raise", exception type, message)."""
    try:
        params, n = reg.get_model(name)
    except Exception as e:  # the outcome under comparison
        return "raise", type(e), str(e)
    return "ok", params, n


def _tiny_params():
    return convert.convert_state_dict(synthetic.reference_state_dict(N_CLASSES, depth=2, wf=2))


def _bad_sha_pth(cache, _):
    url, _n = registry.MODEL_URLS["R231"]
    cache.mkdir()
    (cache / os.path.basename(url)).write_bytes(b"not a real checkpoint")


def _meta_mismatch(cache, params):
    convert.save_npz(registry._npz_cache_path("R231"), params,
                     meta={"source_sha256": "feedface" * 8})


def _meta_match(cache, params):
    convert.save_npz(registry._npz_cache_path("R231"), params,
                     meta={"source_sha256": "d5d2fc3d" + "0" * 56})


def _no_meta(cache, params):
    convert.save_npz(registry._npz_cache_path("R231"), params, meta={})


# tests/test_registry.py's cases: (cache maker, the error both raise or None).
CASES = {
    "cached_pth_with_bad_sha_rejected": (_bad_sha_pth, "Checksum mismatch"),
    "npz_meta_sha_mismatch_rejected": (_meta_mismatch, "records source sha256=feedface"),
    "npz_meta_sha_match_accepted": (_meta_match, None),
    "npz_without_meta_still_loads": (_no_meta, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_registry_cases_agree_with_jax(case, cache):
    make, error = CASES[case]
    params = _tiny_params()
    make(cache, params)
    got, want = _outcome(registry), _outcome(jregistry)
    assert got[0] == want[0], (got, want)
    if error is not None:
        assert got[0] == "raise" and got[1] is want[1] is RuntimeError
        assert error in got[2] and error in want[2]
        assert got[2] == want[2]  # the same text, paths included
    else:
        assert got[2] == want[2] == N_CLASSES
        _assert_same(got[1], want[1])
        _assert_same(got[1], params)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_cache_dir_is_created(pkg, cache):
    assert not cache.exists()
    assert PACKAGES[pkg].cache_dir() == str(cache) and cache.is_dir()


def test_sha_helpers_agree_with_jax(tmp_path):
    path = tmp_path / "blob.bin"
    path.write_bytes(bytes(range(256)) * 4099)
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    for name in ("unet_r231-d5d2fc3d.pth", "plain.pth", "a-b-c.npz"):
        assert registry._sha256_prefix_of_name(name) == jregistry._sha256_prefix_of_name(name)
    assert registry._sha256_full(str(path)) == jregistry._sha256_full(str(path)) == digest
    assert registry._verify_sha(str(path), digest[:8]) == digest
    assert registry._verify_sha(str(path), None) == digest
    for reg in PACKAGES.values():
        with pytest.raises(RuntimeError, match="Checksum mismatch"):
            reg._verify_sha(str(path), "00000000" if digest[:8] != "00000000" else "11111111")


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_unreachable_url_cannot_be_downloaded(pkg, cache):
    """The release file is absent: the ``file://`` fetch fails and nothing
    is left in the cache but the directory."""
    with pytest.raises(RuntimeError, match="could not be downloaded"):
        PACKAGES[pkg].get_model("R231")
    assert os.listdir(cache) == []


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_one_byte_mutation_is_refused(pkg, cache, state_dict, tmp_path, monkeypatch):
    """A release checkpoint with one byte flipped, fetched or placed in the
    cache by hand, fails the sha gate before it is converted."""
    path = _write_release(state_dict, str(tmp_path))
    _point_r231_at(path, monkeypatch)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x01
    with open(path, "wb") as f:  # fetched
        f.write(bytes(data))
    with pytest.raises(RuntimeError, match="Checksum mismatch"):
        PACKAGES[pkg].get_model("R231")
    os.remove(path)  # the fetched copy stays in the cache: placed
    assert os.path.exists(os.path.join(cache, os.path.basename(path)))
    with pytest.raises(RuntimeError, match="Checksum mismatch"):
        PACKAGES[pkg].get_model("R231")
    assert not any(n.endswith(".npz") for n in os.listdir(cache))


def test_fetch_by_each_package_and_cross_read(state_dict, tmp_path, monkeypatch):
    """Each package fetches the release ``.pth`` into its own cache,
    verifies, converts and writes the ``.npz``: equal arrays and meta. Then
    each reads the other's cache, with the release file gone and the fetch
    forbidden."""
    path = _write_release(state_dict, str(tmp_path))
    _point_r231_at(path, monkeypatch)
    sha = hashlib.sha256(open(path, "rb").read()).hexdigest()
    caches, loaded = {}, {}
    for pkg, reg in PACKAGES.items():
        caches[pkg] = str(tmp_path / f"cache_{pkg}")
        monkeypatch.setenv("LUNGMASK_TPU_CACHE", caches[pkg])
        loaded[pkg] = reg.get_model("R231")
        assert sorted(os.listdir(caches[pkg])) == sorted(
            [os.path.basename(path), os.path.basename(path)[:-4] + ".npz"])
    _assert_same(loaded["torch"][0], loaded["jax"][0])
    assert loaded["torch"][1] == loaded["jax"][1] == N_CLASSES
    npz = {pkg: jconvert.load_npz(os.path.join(caches[pkg], os.path.basename(path)[:-4] + ".npz"))
           for pkg in PACKAGES}
    _assert_same(npz["torch"][0], npz["jax"][0])
    _assert_same(npz["torch"][0], convert.convert_pth(path)[0])
    assert npz["torch"][1] == npz["jax"][1] == {
        "source": os.path.basename(path), "model": "R231", "source_sha256": sha}

    os.remove(path)
    for reg in PACKAGES.values():
        monkeypatch.setattr(reg, "_download", _no_fetch)
    for reader, writer in (("jax", "torch"), ("torch", "jax")):
        monkeypatch.setenv("LUNGMASK_TPU_CACHE", caches[writer])
        params, n = PACKAGES[reader].get_model("R231")
        assert n == N_CLASSES
        _assert_same(params, loaded[writer][0])


def _no_fetch(url, dest):
    raise AssertionError(f"fetched {url} again")


def test_placed_pth_is_converted_and_cached_once(state_dict, tmp_path, monkeypatch, cache):
    """A valid release ``.pth`` placed in the cache by hand: no fetch,
    converted once; the second call reads the ``.npz``."""
    path = _write_release(state_dict, str(tmp_path))
    _point_r231_at(path, monkeypatch)
    cache.mkdir()
    shutil.move(path, cache / os.path.basename(path))
    monkeypatch.setattr(registry, "_download", _no_fetch)
    calls = []
    real = convert.convert_pth
    monkeypatch.setattr(convert, "convert_pth", lambda p: calls.append(p) or real(p))
    first, _ = registry.get_model("R231")
    second, _ = registry.get_model("R231")
    assert len(calls) == 1
    _assert_same(first, second)


def test_inferer_after_the_ports_fetch_equals_jax(state_dict, tmp_path, monkeypatch, cache):
    """``LMInferer("R231")`` of both packages on the cache the port filled
    by its fetch: float32, the same mask voxel for voxel (raw predictions
    and postprocessed)."""
    import lungmask_tpu

    from lungmask_tpu_torch import LMInferer

    path = _write_release(state_dict, str(tmp_path))
    _point_r231_at(path, monkeypatch)
    registry.get_model("R231")
    os.remove(path)  # JAX's inferer must read the port's cache
    vol = synthetic.lung_phantom(3, size=64)
    for post in (False, True):
        kw = dict(tqdm_disable=True, precision="float32", volume_postprocessing=post)
        got = LMInferer("R231", force_cpu=True, **kw).apply(vol)
        want = lungmask_tpu.LMInferer("R231", force_cpu=True, **kw).apply(vol)
        assert got.shape == vol.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        if not post:
            assert len(np.unique(got)) >= 2


@pytest.mark.parametrize("dst", ["given", "default"])
def test_converter_equals_the_jax_tool(dst, state_dict, tmp_path):
    """``python -m lungmask_tpu_torch.tools.convert_weights SRC [DST]`` and
    ``tools/convert_weights.py SRC [DST]``: the same arrays and meta, the
    default output named after SRC in the working directory."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = _write_release(state_dict, str(tmp_path))
    outs = {}
    for pkg, cmd in (("torch", ["-m", "lungmask_tpu_torch.tools.convert_weights"]),
                     ("jax", [os.path.join(repo, "tools", "convert_weights.py")])):
        cwd = tmp_path / pkg
        cwd.mkdir()
        args = [src] + ([str(cwd / "out.npz")] if dst == "given" else [])
        res = subprocess.run([sys.executable, *cmd, *args], capture_output=True, text=True,
                             cwd=cwd, timeout=300,
                             env=dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu"))
        assert res.returncode == 0, res.stderr
        assert f"(n_classes={N_CLASSES})" in res.stdout
        name = "out.npz" if dst == "given" else os.path.basename(src)[:-4] + ".npz"
        assert os.listdir(cwd) == [name]
        outs[pkg] = jconvert.load_npz(str(cwd / name))
    _assert_same(outs["torch"][0], outs["jax"][0])
    assert outs["torch"][1] == outs["jax"][1] == {"source": os.path.basename(src)}
