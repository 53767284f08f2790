"""The port's own finishing core (``lungmask_tpu_torch/csrc/postproc.cpp``,
passes over voxels in z-slabs on a pool of threads) against the JAX
package's serial core (``lungmask_tpu.ops.native``, built from
``csrc/postproc.cpp``) and its Python oracle
(``lungmask_tpu.transforms.postprocess._postprocessing_python``), byte for
byte, with one worker and with eight, on volumes cut into slabs of a few
planes (the wrapper's ``_SLAB_VOXELS`` lowered, as a test may)."""

import sys
import threading

import numpy as np
import pytest
from scipy import ndimage

import torch_parity  # noqa: F401  (one torch thread per worker)
from lungmask_tpu.ops import native as jnative
from lungmask_tpu.transforms.postprocess import _postprocessing_python
from lungmask_tpu_torch.ops import native


@pytest.fixture(autouse=True)
def _libs():
    if native.get_lib() is None or jnative.get_lib() is None:
        pytest.skip("native library unavailable (no g++?)")


def _noise_classes(rng, shape, n_classes, sigma=1.2, keep=0.8):
    vol = np.zeros(shape, dtype=np.uint8)
    for v in range(1, n_classes + 1):
        noise = ndimage.gaussian_filter(rng.normal(size=shape), sigma=sigma)
        vol[noise > np.quantile(noise, keep)] = v
    return vol


def _seeded():
    """Multi-class blobs of every size, many crossing slab boundaries."""
    rng = np.random.default_rng(7)
    return [_noise_classes(rng, (int(rng.integers(12, 24)), 36, 40), 4) for _ in range(3)]


def _diagonal():
    """Components joined only diagonally across the plane between two
    slabs (planes 1 and 2 with eight slabs of 16 planes), in x and y, and
    one that touches the next plane nowhere."""
    vol = np.zeros((16, 20, 20), dtype=np.uint8)
    vol[0:2, 3, 3] = 1
    vol[2:4, 4, 4] = 1  # (1,3,3)–(2,4,4): one component under full connectivity
    vol[0:2, 10, 10:14] = 2
    vol[2:5, 11, 14:17] = 2  # (1,10,13)–(2,11,14): diagonal in y and x
    vol[0:2, 16, 2:6] = 2
    vol[2:4, 18, 2:6] = 2  # two rows apart: separate
    vol[5:9, 6:9, 6:9] = 1
    return [vol]


def _u_shape():
    """Two arms that first appear in slab 0 (planes 0-1) and join only in
    slab 2 (plane 5), and between the arms' first voxels in raster order a
    third component of the same value: the stitch decides that the second
    arm takes the first arm's label, not a new one."""
    vol = np.zeros((16, 16, 24), dtype=np.uint8)
    vol[0:6, 4, 2:4] = 3  # arm A
    vol[0:6, 4, 18:20] = 3  # arm B
    vol[5, 4, 2:20] = 3  # the bottom of the U, in slab 2
    vol[0:2, 4, 9:12] = 3  # between the arms' first voxels, never joined
    vol[0:3, 12, 8:14] = 1
    vol[8:16, 2:14, 2:22] = 2  # a large class-2 block under it all
    return [vol]


def _holes():
    """A hollow class-1 box whose cavity spans slabs (a hole), and a second
    cavity that reaches the champion's window border through one tunnel in
    one plane only (not a hole)."""
    vol = np.zeros((16, 24, 40), dtype=np.uint8)
    vol[1:15, 2:22, 2:38] = 1
    vol[3:13, 5:19, 5:16] = 0  # sealed: filled back
    vol[3:13, 5:19, 24:35] = 0  # open through the tunnel below
    vol[8, 12, 35:38] = 0  # tunnel to x = 37, the window's last column, in plane 8
    vol[6:10, 8:12, 8:12] = 2  # an island of class 2 inside the sealed cavity
    return [vol]


def _few_slices():
    """Fewer slices than workers: two and three planes."""
    rng = np.random.default_rng(11)
    return [_noise_classes(rng, (nz, 30, 34), 3, sigma=1.0) for nz in (2, 3)]


def _merge_area():
    """Two class-1 regions of equal area (A, then B in label order; A is the
    interim champion) and a small class-2 region S that borders B alone: S
    merges into B first (smallest), which raises class 1's champion area to
    B's new area, so A, no longer as large, merges into the class-2
    champion C2 below it."""
    vol = np.zeros((10, 22, 24), dtype=np.uint8)
    vol[1:9, 2:10, 2:10] = 1  # A, 512 voxels
    vol[1:9, 2:10, 14:22] = 1  # B, 512 voxels
    vol[1:9, 10:19, 2:10] = 2  # C2, 576 voxels, under A
    vol[1:9, 10, 14:22] = 2  # S, 64 voxels, under B
    vol[4, 15, 15:17] = 2  # under skip_below: neither merged nor kept
    return [vol]


CASES = {
    "seeded": _seeded,
    "diagonal": _diagonal,
    "u_shape": _u_shape,
    "holes": _holes,
    "few_slices": _few_slices,
    "merge_area": _merge_area,
}


def _fusion_python(res_l, res_r):
    res_l = res_l.copy()
    spare = int(res_l.max()) + 1
    res_l[np.logical_and(res_l == 0, res_r > 0)] = spare
    res_l[res_r == 0] = 0
    return _postprocessing_python(res_l, [spare], disable_tqdm=True)


@pytest.mark.parametrize("workers", [1, 8])
@pytest.mark.parametrize("case", [*CASES, "spare"])
def test_core_matches_serial(case, workers, monkeypatch):
    """postprocess (no spare and, in ``spare``, with the fusion's spare
    value), fused_finish, label (both connectivities) and fill_holes equal
    the serial core and the Python oracle byte for byte; with eight workers
    every call of more than one plane runs in more than one slab."""
    monkeypatch.setattr(native, "_workers", lambda: workers)
    monkeypatch.setattr(native, "_SLAB_VOXELS", 1)
    vols = _seeded() + _u_shape() + _holes() if case == "spare" else CASES[case]()
    before = native.finish_counts()
    calls = 0
    for vol in vols:
        if case == "spare":
            spare = [int(vol.max()) + 1]
            fill = vol.copy()
            fill[3 : vol.shape[0] - 3] = 0  # FN-fill and FP-removal both change voxels
            fill[vol == 0] = 1
            got = native.fused_finish(vol, fill)
            np.testing.assert_array_equal(got, jnative.fused_finish(vol, fill))
            np.testing.assert_array_equal(got, _fusion_python(vol, fill))
            calls += 1
        else:
            spare = []
        got = native.postprocess(vol, spare, 3)
        np.testing.assert_array_equal(got, jnative.postprocess(vol, spare, 3))
        np.testing.assert_array_equal(got, _postprocessing_python(vol, spare, disable_tqdm=True))
        calls += 1
        for conn in (1, None):
            lab, n = native.label(vol.astype(np.int32), conn)
            want, n_want = jnative.label(vol.astype(np.int32), conn)
            assert n == n_want
            np.testing.assert_array_equal(lab, want)
        np.testing.assert_array_equal(native.fill_holes(vol == 1), jnative.fill_holes(vol == 1))
    after = native.finish_counts()
    assert after["calls"] - before["calls"] == calls
    assert after["parallel_calls"] - before["parallel_calls"] == (calls if workers > 1 else 0)


def test_fixtures_exercise_what_they_claim():
    """The hand-made volumes hold the structures their names promise, read
    off the serial core: the U's arms share a label with the middle
    component numbered after them; the sealed cavity is filled and the
    tunnelled one is not; in the merge case A ends in class 2 only because
    S's merge raised class 1's champion area."""
    (u,) = _u_shape()
    lab, _ = jnative.label(u.astype(np.int32), None)
    assert lab[0, 4, 2] == lab[0, 4, 18] == 1 and lab[0, 4, 9] == 2
    (h,) = _holes()
    out = jnative.postprocess(h, [], 3)
    assert (out[5, 10, 10] == 1) and (out[5, 10, 30] == 0)
    (m,) = _merge_area()
    out = jnative.postprocess(m, [], 3)
    assert out[5, 5, 5] == 2 and out[4, 15, 15] == 0


def test_concurrent_callers(monkeypatch):
    """More threads than cores drive the core at once, large volumes (split
    into slabs) and small ones (run inline) in turn, with the interpreter
    switching often: each call returns the serial core's bytes, none hangs,
    and the counts add up."""
    monkeypatch.setattr(native, "_SLAB_VOXELS", 4096)
    rng = np.random.default_rng(88)
    large = [_noise_classes(rng, (16, 40, 40), 3) for _ in range(2)]  # 6 slabs at 8 workers
    small = [_noise_classes(rng, (3, 12, 12), 3) for _ in range(2)]  # 432 voxels: inline
    vols = large + small
    wants = [jnative.postprocess(v, [], 3) for v in vols]
    fill = [v.copy() for v in large]
    for f in fill:
        f[:, :, :8] = 0
    want_ff = [jnative.fused_finish(v, f) for v, f in zip(large, fill)]
    threads, rounds = 2 * native._workers() + 2, 6
    bad, errs = [], []

    def work(k):
        try:
            for r in range(rounds):
                i = (k + r) % len(vols)
                if not np.array_equal(native.postprocess(vols[i], [], 3), wants[i]):
                    bad.append(("postprocess", i))
                j = (k + r) % len(large)
                if not np.array_equal(native.fused_finish(large[j], fill[j]), want_ff[j]):
                    bad.append(("fused_finish", j))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    before = native.finish_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert not errs and not bad
    after = native.finish_counts()
    n_small = sum(1 for k in range(threads) for r in range(rounds) if (k + r) % len(vols) >= 2)
    assert after["calls"] - before["calls"] == 2 * threads * rounds
    n_parallel = 2 * threads * rounds - n_small if native._workers() > 1 else 0
    assert after["parallel_calls"] - before["parallel_calls"] == n_parallel
    assert after["voxels"] - before["voxels"] == sum(
        vols[(k + r) % len(vols)].size + large[(k + r) % len(large)].size
        for k in range(threads) for r in range(rounds))
    if native._workers() > 1:
        assert after["max_workers"] >= 2
