"""Host-side connected components + region properties (numpy/scipy).

Replaces the reference's skimage.measure.label / regionprops usage
(lungmask/utils.py:75-76,102,293-298,399-401) with an
implementation that reproduces skimage's observable semantics exactly:

* **Connectivity**: skimage's ``connectivity=k`` on an N-D image means
  neighbors differing in up to ``k`` axes; the default is ``k = ndim``
  (8-connectivity in 2-D, 26 in 3-D).
* **Multi-class labeling**: two pixels join a component iff they are neighbors
  AND hold the same value; 0 is background.
* **Label ordering**: labels are assigned 1..n in raster-scan order of each
  component's first pixel. This ordering is load-bearing for bit-parity: the
  reference sorts regions by area with a stable sort (ties keep label order,
  lungmask/utils.py:299) and breaks neighbor-count ties by
  ascending label (np.unique sorts, utils.py:318-326).

This module is the exact-parity path and the test oracle for the device CC in
``lungmask_tpu_torch.ops.cc``. A C++ ctypes backend can transparently accelerate
:func:`label` (same contract) when built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
from scipy import ndimage


def _structure(ndim: int, connectivity: Optional[int]) -> np.ndarray:
    if connectivity is None:
        connectivity = ndim
    return ndimage.generate_binary_structure(ndim, connectivity)


def _relabel_scan_order(lab: np.ndarray) -> Tuple[np.ndarray, int]:
    """Renumber labels 1..n by first occurrence in raster-scan order."""
    flat = lab.ravel()
    uniq, first_idx = np.unique(flat, return_index=True)
    nz = uniq != 0
    uniq, first_idx = uniq[nz], first_idx[nz]
    order = np.argsort(first_idx, kind="stable")
    mapping = np.zeros(int(lab.max()) + 1, dtype=np.int32)
    mapping[uniq[order]] = np.arange(1, len(uniq) + 1, dtype=np.int32)
    return mapping[lab], len(uniq)


def label(
    image: np.ndarray, connectivity: Optional[int] = None, return_num: bool = False
):
    """skimage.measure.label-compatible multi-class connected components.

    Dispatches to the native C++ union-find (ops/native.py) when built;
    otherwise uses per-value scipy labeling + scan-order renumbering. Both
    produce identical labelings (cross-checked in tests/test_native.py).
    """
    image = np.asarray(image)
    if connectivity is None or connectivity in (1, image.ndim):
        from lungmask_tpu_torch.ops import native

        res = native.label(image, connectivity)
        if res is not None:
            out, num = res
            return (out, num) if return_num else out
    struct = _structure(image.ndim, connectivity)
    values = np.unique(image)
    out = np.zeros(image.shape, dtype=np.int32)
    offset = 0
    for v in values:
        if v == 0:
            continue
        lab, n = ndimage.label(image == v, structure=struct)
        sel = lab > 0
        out[sel] = lab[sel] + offset
        offset += n
    out, num = _relabel_scan_order(out)
    if return_num:
        return out, num
    return out


@dataclass
class Region:
    """The subset of skimage regionprops the reference consumes: ``label``,
    ``area`` (mutable — the reference mutates the regionprops cache in place,
    lungmask/utils.py:339), ``max_intensity``, ``bbox``."""

    label: int
    area: int
    max_intensity: float
    bbox: Tuple[int, ...]  # (min_0, ..., min_n, max_0, ..., max_n), half-open


def regionprops(
    label_image: np.ndarray, intensity_image: Optional[np.ndarray] = None
) -> List[Region]:
    """Regions ordered by ascending label (skimage ordering)."""
    label_image = np.asarray(label_image)
    nmax = int(label_image.max())
    if nmax == 0:
        return []

    from lungmask_tpu_torch.ops import native

    # The native core computes int32 max-intensity; float intensity images
    # and integer dtypes that don't fit int32 (int64/uint32/uint64 would
    # wrap in the unconditional cast) stay on the exact scipy path.
    res = None
    if intensity_image is None or np.can_cast(
        np.asarray(intensity_image).dtype, np.int32
    ):
        res = native.regionprops_arrays(label_image, intensity_image, nmax)
    if res is not None:
        nareas, nmaxint, nbbox = res
        nd = label_image.ndim
        regions = []
        for lbl in range(1, nmax + 1):
            if nareas[lbl - 1] == 0:
                continue
            b = nbbox[lbl - 1]
            bbox = (
                tuple(int(v) for v in b[3 - nd : 3])
                + tuple(int(v) for v in b[6 - nd : 6])
            )
            regions.append(
                Region(
                    label=lbl,
                    area=int(nareas[lbl - 1]),
                    max_intensity=(
                        float(nmaxint[lbl - 1]) if nmaxint is not None else np.nan
                    ),
                    bbox=bbox,
                )
            )
        return regions

    areas = np.bincount(label_image.ravel(), minlength=nmax + 1)
    objects = ndimage.find_objects(label_image, max_label=nmax)
    if intensity_image is not None:
        maxint = ndimage.labeled_comprehension(
            intensity_image, label_image, np.arange(1, nmax + 1), np.max, float, np.nan
        )
    else:
        maxint = [np.nan] * nmax
    regions = []
    for lbl in range(1, nmax + 1):
        sl = objects[lbl - 1]
        if sl is None:
            continue
        bbox = tuple(s.start for s in sl) + tuple(s.stop for s in sl)
        regions.append(
            Region(
                label=lbl,
                area=int(areas[lbl]),
                max_intensity=float(maxint[lbl - 1]),
                bbox=bbox,
            )
        )
    return regions


def keep_largest_connected_component(mask: np.ndarray) -> np.ndarray:
    """Binary mask of the largest CC — reference semantics
    (lungmask/utils.py:390-404): label with default (full)
    connectivity; ties broken by np.argsort order (the LAST region of maximal
    area, i.e. the highest label)."""
    lab = label(mask)
    nmax = int(lab.max())
    if nmax == 0:
        return np.zeros_like(mask, dtype=bool)
    areas = np.bincount(lab.ravel(), minlength=nmax + 1)[1:]
    max_region = int(np.argsort(areas, kind="stable")[-1]) + 1
    return lab == max_region


def fill_holes_3d(mask: np.ndarray) -> np.ndarray:
    """3-D binary hole filling (the reference's ``fill_voids.fill``,
    lungmask/utils.py:352 — documented as a fast drop-in for
    scipy.ndimage.binary_fill_holes with the default cross structure)."""
    from lungmask_tpu_torch.ops import native

    res = native.fill_holes(mask)
    if res is not None:
        return res
    return ndimage.binary_fill_holes(mask)


def area_closing_binary(mask2d: np.ndarray, area_threshold: int = 64) -> np.ndarray:
    """Binary-image equivalent of skimage.morphology.area_closing(...)==1 used
    for single-slice volumes (lungmask/utils.py:344-350):
    fill every 4-connected background component with area < threshold.
    """
    bg = mask2d == 0
    lab, n = ndimage.label(bg)  # default cross structure = connectivity 1
    if n == 0:
        return mask2d.astype(bool)
    areas = np.bincount(lab.ravel(), minlength=n + 1)
    small = np.zeros(n + 1, dtype=bool)
    small[1:] = areas[1:] < area_threshold
    return mask2d.astype(bool) | small[lab]


def bbox_nd(mask: np.ndarray, margin: int = 2) -> np.ndarray:
    """Margin-padded bounding box, clamped — reference ``bbox_3D``
    (lungmask/utils.py:361-387). Returns [min0, max0, min1, max1, ...]
    half-open."""
    out = []
    for dim in range(mask.ndim):
        axes = tuple(d for d in range(mask.ndim) if d != dim)
        any_along = np.any(mask, axis=axes)
        nz = np.where(any_along)[0]
        bmin, bmax = int(nz[0]), int(nz[-1])
        out.append(max(bmin - margin, 0))
        out.append(min(bmax + margin + 1, mask.shape[dim]))
    return np.asarray(out)
