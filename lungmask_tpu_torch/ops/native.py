"""ctypes bindings for the native host core (counterpart of
``lungmask_tpu.ops.native``).

The port shares the JAX package's C++ host core: ``csrc/postproc.cpp`` and
``csrc/preproc.cpp`` at the repository root are compiled with g++ into
``lungmask_tpu_torch/_build/libpostproc.so`` on first use (a few seconds) and
bound with ctypes. They provide union-find connected components, fused
regionprops, hole filling, the one-call exact postprocessing, the fused
two-model finish, the mask paste-back, the bit unpack and the
crop+resize+normalize resampler. Callers
fall back to the numpy/scipy implementations when no compiler is available;
:func:`native_loaded` reports whether the core loaded.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from lungmask_tpu_torch.logger import logger

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(os.path.dirname(_PKG), "csrc")
_SRCS = [os.path.join(CSRC_DIR, name) for name in ("postproc.cpp", "preproc.cpp")]
BUILD_DIR = os.path.join(_PKG, "_build")
_OUT = os.path.join(BUILD_DIR, "libpostproc.so")


@contextlib.contextmanager
def build_lock(out_path: str):
    """Exclusive file lock beside ``out_path`` for the build step: parallel
    test workers or processes that start together build once, and none of
    them loads a library another is still writing."""
    import fcntl

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path + ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _host_cpu_signature() -> str:
    """Stable signature of the CPU the library was tuned for: the model name
    + feature flags from /proc/cpuinfo (hashed), or the platform string where
    that file doesn't exist."""
    import hashlib
    import platform

    try:
        with open("/proc/cpuinfo", "r") as f:
            text = f.read()
        fields = [
            line
            for line in text.splitlines()
            if line.startswith(("model name", "flags", "Features"))
        ]
        raw = "\n".join(sorted(set(fields))) or text[:4096]
    except OSError:
        raw = platform.platform() + platform.processor()
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def _read(path: str) -> Optional[str]:
    try:
        with open(path, "r") as f:
            return f.read().strip()
    except OSError:
        return None


def _write(path: str, value: str) -> None:
    try:
        with open(path, "w") as f:
            f.write(value)
    except OSError:
        pass  # unwritable cache dir: freshness degrades to mtime-only


def build_or_load_library(srcs, out_path: str) -> Optional[ctypes.CDLL]:
    """Shared native-core scaffolding: rebuild ``out_path`` from ``srcs`` when
    missing or stale, then ctypes-load it.

    A failed REbuild (e.g. no compiler on this host, but the .so was built
    elsewhere or earlier) falls back to loading the existing library instead
    of discarding it — mtime churn from a checkout/rsync must not disable a
    working codec. Returns None only when nothing loadable exists. The build
    runs under :func:`build_lock` and writes a temporary file that replaces
    ``out_path`` atomically.
    """
    srcs = [s for s in srcs if os.path.exists(s)]
    with build_lock(out_path):
        exists = os.path.exists(out_path)
        info_path = out_path + ".buildinfo"
        fresh = (
            exists
            and srcs
            and all(os.path.getmtime(s) <= os.path.getmtime(out_path) for s in srcs)
            # -march=native builds are host-specific: a .so carried to a
            # different CPU must rebuild, not SIGILL. The sidecar records the
            # CPU signature it was built for.
            and _read(info_path) == _host_cpu_signature()
        )
        if not fresh and srcs:
            tmp = f"{out_path}.{os.getpid()}.tmp"
            base = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", *srcs, "-o", tmp]
            # Host-tuned first; plain -O3 retry keeps unusual toolchains working.
            for extra in (["-march=native", "-funroll-loops"], []):
                cmd = base[:2] + extra + base[2:]
                try:
                    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                    os.replace(tmp, out_path)
                    _write(info_path, _host_cpu_signature())
                    break
                except (OSError, subprocess.SubprocessError) as e:
                    err = e
            else:
                if exists:
                    logger.info(
                        f"native rebuild failed ({err}); reusing existing "
                        f"{os.path.basename(out_path)}"
                    )
                else:
                    logger.info(f"native build skipped ({err}); using fallbacks")
                    return None
    if not os.path.exists(out_path):
        return None
    try:
        return ctypes.CDLL(out_path)
    except OSError as e:
        logger.info(f"native load failed ({e}); using fallbacks")
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    lib = build_or_load_library(_SRCS, _OUT)
    if lib is None:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.lm_label.restype = ctypes.c_int32
    lib.lm_label.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, i32p
    ]
    lib.lm_regionprops.restype = None
    lib.lm_regionprops.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, i64p, i32p, i32p,
    ]
    lib.lm_fill_holes.restype = None
    lib.lm_fill_holes.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    if hasattr(lib, "lm_unpack_bits"):
        lib.lm_unpack_bits.restype = ctypes.c_int32
        lib.lm_unpack_bits.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32, u8p]
    if hasattr(lib, "lm_postprocess"):
        lib.lm_postprocess.restype = ctypes.c_int32
        lib.lm_postprocess.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i32p, ctypes.c_int32, ctypes.c_int32, u8p,
        ]
    if hasattr(lib, "lm_fused_finish"):
        lib.lm_fused_finish.restype = ctypes.c_int32
        lib.lm_fused_finish.argtypes = [
            u8p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, u8p,
        ]
    if hasattr(lib, "lm_paste_masks"):
        lib.lm_paste_masks.restype = ctypes.c_int32
        lib.lm_paste_masks.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i32p, ctypes.c_int64, ctypes.c_int64, u8p,
        ]
    if hasattr(lib, "lm_crop_resize_norm_i16"):
        i16p = ctypes.POINTER(ctypes.c_int16)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.lm_crop_resize_norm_i16.restype = ctypes.c_int32
        lib.lm_crop_resize_norm_i16.argtypes = [
            i16p, i64, i64, i64, i32p, i64, i64, f32p
        ]
    _LIB = lib
    return _LIB


def native_loaded() -> bool:
    """Whether the C++ host core built (or was found) and loaded."""
    return get_lib() is not None


def _as3d(a: np.ndarray) -> np.ndarray:
    return a[None] if a.ndim == 2 else a


def label(image: np.ndarray, connectivity: Optional[int] = None):
    """Native CC labeling; returns (labels int32, n) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    img = _as3d(np.ascontiguousarray(image, dtype=np.int32))
    nz, ny, nx = img.shape
    conn = 1 if connectivity == 1 else 0  # 0 = full
    out = np.empty_like(img)
    n = lib.lm_label(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nz, ny, nx, conn,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if n < 0:
        return None
    return out.reshape(image.shape), int(n)


def regionprops_arrays(labels: np.ndarray, intensity: Optional[np.ndarray], n: int):
    """Native fused regionprops → (areas int64, max_int int32|None, bbox (n,6))."""
    lib = get_lib()
    if lib is None:
        return None
    lab = _as3d(np.ascontiguousarray(labels, dtype=np.int32))
    nz, ny, nx = lab.shape
    areas = np.zeros(n, dtype=np.int64)
    maxint = np.zeros(n, dtype=np.int32)
    bbox = np.zeros((n, 6), dtype=np.int32)
    ip = ctypes.POINTER(ctypes.c_int32)
    inten_ptr = ip()
    if intensity is not None:
        inten = _as3d(np.ascontiguousarray(intensity, dtype=np.int32))
        inten_ptr = inten.ctypes.data_as(ip)
    lib.lm_regionprops(
        lab.ctypes.data_as(ip), inten_ptr, nz, ny, nx, n,
        areas.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        maxint.ctypes.data_as(ip),
        bbox.ctypes.data_as(ip),
    )
    return areas, (maxint if intensity is not None else None), bbox


def crop_resize_normalize(
    volume: np.ndarray, boxes: np.ndarray, out_shape
) -> Optional[np.ndarray]:
    """Native fused crop + scipy-exact bilinear resize + HU window + normalize.

    (n, H, W) integer HU volume + (n, 4) half-open boxes → (n, out_h, out_w)
    float32 in [0, 1]. Returns None when the native core is unavailable OR
    the volume is float (no rounding cast exists there to absorb the last-ulp
    two-pass-vs-scipy float64 difference — see csrc/preproc.cpp); callers
    fall back to the scipy path. Non-int16 integers are clipped to
    [−1024, 600] first, which loses nothing (the kernel clips identically,
    lungmask/utils.py:45).
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "lm_crop_resize_norm_i16"):
        return None
    if not np.issubdtype(volume.dtype, np.integer):
        return None
    n, h, w = volume.shape
    out_h, out_w = out_shape
    b = np.ascontiguousarray(boxes, dtype=np.int32)
    out = np.empty((n, out_h, out_w), dtype=np.float32)
    if volume.dtype == np.int16:
        v = np.ascontiguousarray(volume)
    else:
        v = np.clip(volume, -1024, 600).astype(np.int16)
    rc = lib.lm_crop_resize_norm_i16(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        n, h, w,
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out if rc == 0 else None


def unpack_bits(packed: np.ndarray, bits: int) -> Optional[np.ndarray]:
    """Expand 2- or 4-bit packed class maps along the last axis (see
    runtime/engine.py). Returns None when the native core is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "lm_unpack_bits"):
        return None
    p = np.ascontiguousarray(packed, dtype=np.uint8)
    per = 8 // bits
    out = np.empty(p.shape[:-1] + (p.shape[-1] * per,), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.lm_unpack_bits(
        p.ctypes.data_as(u8p), p.size, bits, out.ctypes.data_as(u8p)
    )
    return out if rc == 0 else None


def postprocess(
    label_image: np.ndarray, spare, skip_below: int
) -> Optional[np.ndarray]:
    """Full exact volume postprocessing in one native call (lm_postprocess,
    voxel-identical to transforms.postprocess.postprocessing — differential
    tests in tests/test_native.py). Returns None when unavailable or when the
    input needs the Python path (single-slice volumes, non-uint8 values)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "lm_postprocess"):
        return None
    if label_image.ndim != 3 or label_image.shape[0] < 2:
        return None
    if label_image.dtype != np.uint8:
        if np.issubdtype(label_image.dtype, np.integer) and (
            label_image.size == 0 or (0 <= label_image.min() and label_image.max() <= 255)
        ):
            label_image = label_image.astype(np.uint8)
        else:
            return None
    img = np.ascontiguousarray(label_image)
    nz, ny, nx = img.shape
    sp = np.ascontiguousarray(np.asarray(list(spare), dtype=np.int32))
    out = np.empty_like(img)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.lm_postprocess(
        img.ctypes.data_as(u8p), nz, ny, nx,
        sp.ctypes.data_as(i32p), len(sp), int(skip_below),
        out.ctypes.data_as(u8p),
    )
    return out if rc == 0 else None


def fused_finish(
    res_l: np.ndarray, res_r: np.ndarray, skip_below: int = 3
) -> Optional[np.ndarray]:
    """One-call fused-path finish (reference mask.py:228-232: spare-value
    FN-fill + FP-removal + spare-aware postprocessing). Returns None when the
    native core is unavailable or the inputs need the Python path (fewer
    than 2 slices, non-uint8 masks)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "lm_fused_finish"):
        return None
    if (
        res_l.shape != res_r.shape
        or res_l.ndim != 3
        or res_l.shape[0] < 2
        or res_l.dtype != np.uint8
        or res_r.dtype != np.uint8
    ):
        return None
    a = np.ascontiguousarray(res_l)
    b = np.ascontiguousarray(res_r)
    nz, ny, nx = a.shape
    out = np.empty_like(a)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.lm_fused_finish(
        a.ctypes.data_as(u8p), b.ctypes.data_as(u8p), nz, ny, nx,
        int(skip_below), out.ctypes.data_as(u8p),
    )
    return out if rc == 0 else None


def paste_masks(
    masks: np.ndarray, boxes: np.ndarray, canvas_shape
) -> Optional[np.ndarray]:
    """Batched reshape_mask paste-back (lm_paste_masks) — bit-identical to
    ``ops.resample.paste_masks_numpy``'s loop but one GIL-free native pass.
    Returns None when the native core is
    unavailable or the inputs need the numpy path (non-uint8 masks, boxes
    outside the canvas)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "lm_paste_masks"):
        return None
    if masks.dtype != np.uint8 or masks.ndim != 3:
        return None
    m = np.ascontiguousarray(masks)
    b = np.ascontiguousarray(boxes, dtype=np.int32)
    n, mh, mw = m.shape
    h, w = canvas_shape
    if b.shape != (n, 4):
        return None
    out = np.empty((n, h, w), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.lm_paste_masks(
        m.ctypes.data_as(u8p), n, mh, mw,
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        h, w, out.ctypes.data_as(u8p),
    )
    return out if rc == 0 else None


def fill_holes(mask: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    m = _as3d(np.ascontiguousarray(mask, dtype=np.uint8)).copy()
    nz, ny, nx = m.shape
    lib.lm_fill_holes(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nz, ny, nx
    )
    return m.reshape(mask.shape).astype(bool)
