"""Volumetric medical image container with LPS geometry.

Replaces the reference's dependence on ``SimpleITK.Image`` (geometry +
metadata carrier, lungmask/mask.py:156-164,204-208 and
utils.py:215-268) with a small numpy-based container.

Conventions (matching ITK/SimpleITK so behavior is comparable):

* Physical space is **LPS** (+x → patient Left, +y → Posterior, +z → Superior).
* ``direction`` is a 3×3 matrix whose COLUMN j is the unit vector, in physical
  LPS space, along which image axis j (x=fastest, y, z=slowest) advances.
* ``origin``/``spacing`` are physical coordinates of voxel (0,0,0) and voxel
  pitch, both in (x, y, z) order.
* The voxel ``array`` is indexed ``[z, y, x]`` (the layout
  ``sitk.GetArrayFromImage`` exposes, which the whole pipeline operates in).
* ``metadata`` holds DICOM tags under ``"gggg|eeee"`` lowercase-hex keys, the
  key format the reference's CLI metadata propagation uses
  (lungmask/__main__.py:125-141).

Orientation codes are 3-letter strings naming, per image axis, the physical
direction the axis points toward ("LPS" ⇔ direction ≈ identity), mirroring
``sitk.DICOMOrientImageFilter`` semantics.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

_AXIS_LETTERS = (("R", "L"), ("A", "P"), ("I", "S"))  # (negative, positive) per phys axis
_LETTER_TO_AXIS = {
    "R": (0, -1), "L": (0, +1),
    "A": (1, -1), "P": (1, +1),
    "I": (2, -1), "S": (2, +1),
}


@dataclass
class MedicalImage:
    """A 3-D image: voxels [z, y, x] + LPS geometry + DICOM-style metadata."""

    array: np.ndarray
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)  # (x, y, z)
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # (x, y, z)
    direction: np.ndarray = field(default_factory=lambda: np.eye(3))
    metadata: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        self.array = np.asarray(self.array)
        if not self.array.flags.writeable:
            # Readers hand in np.frombuffer views over immutable file bytes:
            # read-only (callers following the sitk mutable-array model would
            # crash) and pinning the entire file buffer. Own a writable copy.
            self.array = np.array(self.array)
        if self.array.ndim != 3:
            raise ValueError(f"expected 3-D array, got shape {self.array.shape}")
        self.direction = np.asarray(self.direction, dtype=np.float64).reshape(3, 3)
        self.spacing = tuple(float(s) for s in self.spacing)
        self.origin = tuple(float(o) for o in self.origin)

    @property
    def size(self) -> Tuple[int, int, int]:
        """(x, y, z) voxel counts — sitk GetSize() order."""
        z, y, x = self.array.shape
        return (x, y, z)

    def voxel_count(self) -> int:
        return int(np.prod(self.array.shape))

    def with_array(self, array: np.ndarray) -> "MedicalImage":
        """Same geometry/metadata, new voxels (sitk CopyInformation pattern,
        lungmask/__main__.py:119-120)."""
        if array.shape != self.array.shape:
            raise ValueError(
                f"shape mismatch: {array.shape} vs {self.array.shape}"
            )
        return MedicalImage(
            array=array,
            spacing=self.spacing,
            origin=self.origin,
            direction=self.direction.copy(),
            metadata=dict(self.metadata),
        )

    # ------------------------------------------------------------------
    # Orientation
    # ------------------------------------------------------------------

    def orientation(self) -> str:
        return orientation_code(self.direction)

    def reoriented(self, target: str = "LPS") -> "MedicalImage":
        return reorient(self, target)


def coerce_for_write(array: np.ndarray, supported, fallback=np.float32) -> np.ndarray:
    """Shared writer preamble: contiguous array, bool → uint8, and any dtype
    a format cannot represent → ``fallback``. ``supported`` is the format's
    dtype table (anything ``dtype in supported`` works)."""
    arr = np.ascontiguousarray(array)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype not in supported:
        arr = arr.astype(fallback)
    return arr


def orientation_code(direction: np.ndarray) -> str:
    """3-letter code of the dominant physical direction of each image axis.

    Equivalent to
    ``sitk.DICOMOrientImageFilter_GetOrientationFromDirectionCosines`` used at
    lungmask/mask.py:157-161.
    """
    d = np.asarray(direction, dtype=np.float64).reshape(3, 3)
    code = []
    for j in range(3):
        i = int(np.argmax(np.abs(d[:, j])))
        code.append(_AXIS_LETTERS[i][1 if d[i, j] > 0 else 0])
    return "".join(code)


def _axis_plan(direction: np.ndarray, target: str):
    """For each target slot k: (source image axis j, flip?)."""
    d = np.asarray(direction, dtype=np.float64).reshape(3, 3)
    dominant = []  # per image axis j: (physical axis, sign)
    for j in range(3):
        i = int(np.argmax(np.abs(d[:, j])))
        dominant.append((i, 1 if d[i, j] > 0 else -1))
    plan = []
    used = set()
    for k, letter in enumerate(target.upper()):
        if letter not in _LETTER_TO_AXIS:
            raise ValueError(f"bad orientation letter {letter!r}")
        phys, want_sign = _LETTER_TO_AXIS[letter]
        js = [j for j, (p, _) in enumerate(dominant) if p == phys and j not in used]
        if not js:
            raise ValueError(
                f"orientation {target!r} unreachable: no image axis is dominant "
                f"along physical axis {phys}"
            )
        j = js[0]
        used.add(j)
        plan.append((j, dominant[j][1] != want_sign))
    return plan


def reorient(image: MedicalImage, target: str = "LPS", dtype=None) -> MedicalImage:
    """Permute/flip image axes so the orientation code becomes ``target``.

    Behavioral equivalent of ``sitk.DICOMOrient(image, target)``
    (lungmask/mask.py:163,207): a pure axis shuffle — voxel
    values are never resampled — with origin/direction updated so physical
    positions are preserved. The flips and the permutation compose into one
    view of the voxels, written once by :func:`copy_voxels` into a new array
    of ``dtype`` (the input's by default; cast as ``astype`` casts).
    """
    plan = _axis_plan(image.direction, target)

    d = image.direction.copy()
    spacing = list(image.spacing)
    origin = np.asarray(image.origin, dtype=np.float64)
    arr = image.array

    # First apply flips in the ORIGINAL axis frame.
    flip_src = [j for j, flip in plan if flip]
    for j in flip_src:
        n = arr.shape[2 - j]  # array is [z, y, x]; image axis j ↔ array axis 2-j
        origin = origin + d[:, j] * spacing[j] * (n - 1)
        d[:, j] = -d[:, j]
    if flip_src:
        arr = np.flip(arr, axis=[2 - j for j in flip_src])

    # Then permute: new image axis k comes from source axis j.
    perm = [j for j, _ in plan]  # length 3
    d = d[:, perm]
    spacing = tuple(spacing[j] for j in perm)
    # array axes: new array axis (2-k) = old array axis (2-perm[k])
    arr = np.transpose(arr, axes=[2 - perm[2 - a] for a in range(3)])

    return MedicalImage(
        array=copy_voxels(arr, dtype),
        spacing=spacing,
        origin=tuple(origin),
        direction=d,
        metadata=dict(image.metadata),
    )


# -- the voxel copy ---------------------------------------------------------------
#
# A whole volume written once: the copy runs in slabs of the result's axis 0,
# on a process-wide pool and the calling thread (np.copyto releases the GIL;
# each thread also takes the page faults of the slab it writes). One pool for
# every caller: the fused pair's two finishes and the cohort's loader and
# finisher copy at the same time, and a pool per call would start threads for
# every volume.

_SLAB_BYTES = 2 << 20  # the least a slab writes; a copy of fewer than two runs inline
_pool_lock = threading.Lock()
_pool = None
_counts_lock = threading.Lock()
_counts = {"passes": 0, "parallel_passes": 0, "slabs": 0, "max_workers": 0, "bytes": 0}


def reorient_counts() -> dict:
    """Process-wide counts of :func:`copy_voxels` passes since the process
    started: ``passes``, ``parallel_passes`` (slabs copied on more than one
    thread), ``slabs`` copied, ``max_workers``, the most threads one pass
    used, and ``bytes`` written."""
    with _counts_lock:
        return dict(_counts)


def _copy_workers() -> int:
    """Threads a copy may use, the caller's included: the process's CPUs, at
    most 8."""
    return min(8, len(os.sched_getaffinity(0)))


def _executor() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max(1, _copy_workers() - 1),
                                       thread_name_prefix="voxel-copy")
        return _pool


def copy_voxels(src: np.ndarray, dtype=None) -> np.ndarray:
    """``src``, any strided view, as a new C-contiguous array of ``dtype``
    (``src``'s own by default; cast as ``astype`` casts, wrapping included),
    in one pass: slabs of at least ``_SLAB_BYTES`` along axis 0, one a
    thread, the first on the calling thread."""
    out = np.empty(src.shape, dtype=src.dtype if dtype is None else dtype)
    rows = len(out)
    n = max(1, min(_copy_workers(), out.nbytes // _SLAB_BYTES, rows))
    cuts = [rows * i // n for i in range(n + 1)]
    if n > 1:
        pool = _executor()
        futures = [pool.submit(np.copyto, out[a:b], src[a:b], casting="unsafe")
                   for a, b in zip(cuts[1:-1], cuts[2:])]
        try:
            np.copyto(out[: cuts[1]], src[: cuts[1]], casting="unsafe")
        finally:
            for f in futures:
                f.result()
    else:
        np.copyto(out, src, casting="unsafe")
    with _counts_lock:
        _counts["passes"] += 1
        _counts["parallel_passes"] += int(n > 1)
        _counts["slabs"] += n
        _counts["max_workers"] = max(_counts["max_workers"], n)
        _counts["bytes"] += out.nbytes
    return out
