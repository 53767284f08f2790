"""The port's reorientation as one pass (``io/image.py``: ``reorient`` over
``copy_voxels``) against the JAX package's two-copy ``reorient``, and the
inferer's entry around it (``LMInferer._to_lps``, ``_from_lps``) against the
entry's semantics as the JAX package keeps them: the reoriented copy, then
``_hu_capable``'s promotion, and the mask reoriented back, then
``astype(np.uint8)``."""

import itertools
import sys
import threading

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
import lungmask_tpu
from lungmask_tpu.io import image as jimage
from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.io import image
from lungmask_tpu_torch.models import convert, synthetic

GEOMETRY = dict(spacing=(0.7, 0.8, 2.5), origin=(10.0, -20.0, 5.0))
RAS = np.diag([-1.0, -1.0, 1.0])


def _signed_permutations():
    """The 48 direction matrices whose columns are signed unit axes."""
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1.0, -1.0), repeat=3):
            d = np.zeros((3, 3))
            d[list(perm), range(3)] = signs
            yield d


def _voxels(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if dtype == np.float32:
        return rng.normal(0.0, 300.0, shape).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1024), min(info.max, 3071), shape, endpoint=True).astype(dtype)


def _assert_owned(out: np.ndarray, src: np.ndarray) -> None:
    assert out.flags.c_contiguous and out.flags.writeable
    assert not np.shares_memory(out, src)


def _assert_same(port_img, jax_img) -> None:
    assert port_img.array.dtype == jax_img.array.dtype
    np.testing.assert_array_equal(port_img.array, jax_img.array)
    assert port_img.spacing == jax_img.spacing
    assert port_img.origin == jax_img.origin
    np.testing.assert_array_equal(port_img.direction, jax_img.direction)
    assert port_img.metadata == jax_img.metadata


def _round_trip(arr: np.ndarray, direction: np.ndarray) -> None:
    """``arr`` under ``direction`` to LPS and back, in both packages."""
    meta = {"0010|0010": "phantom"}
    src = image.MedicalImage(arr, direction=direction, metadata=meta, **GEOMETRY)
    ref = jimage.MedicalImage(arr, direction=direction, metadata=meta, **GEOMETRY)
    code = src.orientation()
    lps, ref_lps = image.reorient(src, "LPS"), jimage.reorient(ref, "LPS")
    _assert_same(lps, ref_lps)
    _assert_owned(lps.array, arr)
    back = image.reorient(lps, code)
    _assert_same(back, jimage.reorient(ref_lps, code))
    _assert_owned(back.array, lps.array)
    np.testing.assert_array_equal(back.array, arr)


@pytest.mark.parametrize("case", ["int16", "uint8", "float32", "bool", "parallel", "view"])
def test_reorient_matches_jax(case, monkeypatch):
    """All 48 signed axis permutations of an odd 7×5×3 volume in each dtype;
    a volume of several slabs (the pass must run in parallel); a strided,
    reversed view as input. Voxels, dtype and geometry equal the JAX
    package's; every result is a new C-contiguous, writeable array."""
    if case == "parallel":
        monkeypatch.setattr(image, "_copy_workers", lambda: 4)
        arr = _voxels(np.int16, (64, 256, 256))  # 8 MiB: four slabs of 2 MiB
        for d in (RAS, np.asarray([[0, 1.0, 0], [1.0, 0, 0], [0, 0, -1.0]])):
            before = image.reorient_counts()
            _round_trip(arr, d)
            after = image.reorient_counts()
            assert after["passes"] - before["passes"] == 2
            assert after["parallel_passes"] - before["parallel_passes"] == 2
            assert after["slabs"] - before["slabs"] == 8
            assert after["bytes"] - before["bytes"] == 2 * arr.nbytes
            assert after["max_workers"] >= 4
        return
    if case == "view":
        base = _voxels(np.int16, (9, 12, 8))
        arr = base[1::2, ::-1, 2:7].swapaxes(0, 2)
        assert not arr.flags.c_contiguous
        for d in (RAS, next(_signed_permutations())):
            _round_trip(arr, d)
        return
    arr = _voxels(np.dtype(case).type, (7, 5, 3))
    for d in _signed_permutations():
        _round_trip(arr, d)


def test_copy_voxels_under_contention(monkeypatch):
    """More callers than cores, each copying volumes of several slabs on the
    shared pool with the interpreter switching threads often: every copy is
    right and no count is lost."""
    monkeypatch.setattr(image, "_SLAB_BYTES", 1 << 13)
    arr = _voxels(np.int16, (16, 64, 64))  # 64 KiB written: up to eight slabs
    view = arr[:, ::-1, ::-1]
    want = np.ascontiguousarray(view).astype(np.uint8)
    threads, rounds = 2 * image._copy_workers() + 2, 20
    bad = []

    def work():
        for _ in range(rounds):
            if not np.array_equal(image.copy_voxels(view, np.uint8), want):
                bad.append(1)

    before = image.reorient_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    after = image.reorient_counts()
    n = threads * rounds
    slabs = min(image._copy_workers(), 8)  # as many as the host's threads allow
    assert bad == []
    assert after["passes"] - before["passes"] == n
    assert after["slabs"] - before["slabs"] == n * slabs
    assert after["bytes"] - before["bytes"] == n * want.nbytes


# -- the inferer's entry ------------------------------------------------------------


@pytest.fixture(scope="module")
def inferer(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "laterality_wf2.npz")
    convert.save_npz(path, synthetic.laterality_params(wf=2))
    return LMInferer(modelpath=path, device="cpu", precision="float32", tqdm_disable=True)


@pytest.mark.parametrize("case", ["uint8", "uint16", "int8", "bool", "ndarray", "lps"])
def test_entry_matches_two_pass_entry(inferer, case):
    """``_to_lps`` promotes as ``_hu_capable`` does and ``_from_lps`` casts
    as ``astype(np.uint8)`` does (wrapping), in the one reorienting pass; an
    ndarray is copied, never aliased or written; an LPS image of int16 with
    a uint8 mask makes no pass."""
    promote = lungmask_tpu.LMInferer._hu_capable
    shape = (6, 10, 8)
    mask = _voxels(np.int16, shape, seed=1).astype(np.int32) % 300  # wraps past 255
    if case == "ndarray":
        arr = _voxels(np.uint16, shape)
        kept = arr.copy()
        vol, orient, lps = inferer._to_lps(arr)
        assert (orient, lps) == (None, None)
        assert vol.dtype == promote(arr).dtype
        np.testing.assert_array_equal(vol, promote(arr.copy()))
        assert not np.shares_memory(vol, arr)
        vol[...] = 0
        np.testing.assert_array_equal(arr, kept)
        out = inferer._from_lps(mask, None, None)
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out, mask.astype(np.uint8))
        return
    if case == "lps":
        img = image.MedicalImage(_voxels(np.int16, shape), **GEOMETRY)
        before = image.reorient_counts()
        vol, orient, lps = inferer._to_lps(img)
        assert orient == "LPS" and vol is img.array
        mask8 = mask.astype(np.uint8)
        out = inferer._from_lps(mask8, orient, lps)
        np.testing.assert_array_equal(out, mask8)
        assert out.dtype == np.uint8
        assert image.reorient_counts() == before
        return
    arr = _voxels(np.dtype(case).type, shape)
    img = image.MedicalImage(arr, direction=RAS, **GEOMETRY)
    ref_lps = jimage.reorient(jimage.MedicalImage(arr, direction=RAS, **GEOMETRY), "LPS")
    vol, orient, lps = inferer._to_lps(img)
    want = promote(ref_lps.array)
    assert orient == "RAS" and vol.dtype == want.dtype
    np.testing.assert_array_equal(vol, want)
    _assert_owned(vol, arr)
    assert (lps.spacing, lps.origin) == (ref_lps.spacing, ref_lps.origin)
    np.testing.assert_array_equal(lps.direction, ref_lps.direction)
    out = inferer._from_lps(mask, orient, lps)
    ref_back = jimage.reorient(
        jimage.MedicalImage(mask, spacing=ref_lps.spacing, origin=ref_lps.origin,
                            direction=ref_lps.direction), orient)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref_back.array.astype(np.uint8))
    _assert_owned(out, mask)
