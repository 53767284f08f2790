"""Volume postprocessing: component cleanup, neighbor-merge relabeling, hole fill
(a copy of ``lungmask_tpu.transforms.postprocess``; ``tqdm`` is optional).

Re-derivation of the reference's ``utils.postprocessing``
(lungmask/utils.py:272-358) with identical observable
semantics, including its quirks (documented inline), but restructured for
speed: every per-region operation works on the region's current bounding
window instead of the full volume, turning the reference's
O(regions × volume) Python loop into O(Σ region-window volumes). On typical
CT volumes this is orders of magnitude faster and is the main reason the
fused-model path drops from "several minutes" (reference README.md:9) to
sub-second host time.

Observable semantics preserved exactly (verified by the reference's own
postprocessing unit-test vectors in tests/test_postprocess.py):

* 3-D connected components of the multi-class map with full (26) connectivity
  and raster-scan label ordering.
* Regions processed in ascending-area order (stable sort → ties keep
  scan order).
* A region merges into the neighbor sharing the largest dilated border,
  neighbor-count ties broken by ascending label; labels numerically present in
  ``spare`` are excluded as merge targets (the reference compares *region
  labels* against ``spare`` — which holds intensity values — at utils.py:323;
  we reproduce that comparison verbatim).
* The merge-target's cached area grows (utils.py:339) and, when the target is
  currently the largest component of its intensity, the per-intensity max
  grows too (utils.py:330-338) — both affect later regions' merge conditions.
* Regions smaller than ``skip_below`` neither merge nor update caches; they
  die in the final largest-CC sweep.
* Final sweep iterates ``np.unique(mapped)[1:]`` (utils.py:355) — verbatim,
  including the implicit assumption that 0 is present.
* Hole filling: 3-D fill for volumes, binary area-closing (<64 px, 4-conn)
  for single-slice volumes (utils.py:344-352).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import ndimage
from lungmask_tpu_torch.logger import logger
from lungmask_tpu_torch.ops import cc_host

try:
    from tqdm import tqdm
except ImportError:  # progress bars are optional

    def tqdm(iterable, **_kwargs):
        return iterable


def _expand_box(lo: np.ndarray, hi: np.ndarray, shape, margin: int = 2):
    lo = np.maximum(lo - margin, 0)
    hi = np.minimum(hi + margin, shape)
    return lo, hi


def postprocessing(
    label_image: np.ndarray,
    spare: Sequence[int] = (),
    disable_tqdm: bool = False,
    skip_below: int = 3,
) -> np.ndarray:
    """Map small label patches to the neighbor sharing the largest border,
    keep only each label's largest connected component, fill holes.

    Dispatches to the one-call native core (the port's
    ``csrc/postproc.cpp`` ``lm_postprocess``, its passes over voxels in
    z-slabs on the host's CPUs) when built — voxel-identical by differential
    test (tests/test_torch_native.py). The Python implementation below is
    the oracle and the fallback.

    Args:
        label_image: int label volume (z, y, x).
        spare: labels used for neighbor mapping but erased from the final
            result (the fusion path's FN-fill marker, see LMInferer.apply).
        skip_below: components smaller than this are removed instead of merged.

    Returns:
        uint8 postprocessed volume.
    """
    label_image = np.asarray(label_image)
    logger.info("Postprocessing")
    spare = list(spare)

    if label_image.ndim == 3:
        from lungmask_tpu_torch.ops import native

        res = native.postprocess(label_image, spare, skip_below)
        if res is not None:
            return res
    return _postprocessing_python(
        label_image, spare, disable_tqdm=disable_tqdm, skip_below=skip_below
    )


def _postprocessing_python(
    label_image: np.ndarray,
    spare: Sequence[int] = (),
    disable_tqdm: bool = False,
    skip_below: int = 3,
) -> np.ndarray:
    """Pure numpy/scipy implementation — the exact-semantics oracle."""
    label_image = np.asarray(label_image)
    spare = list(spare)

    comp_map = cc_host.label(label_image)
    max_class = int(label_image.max())
    # Running "largest component seen so far" per output class; merges that
    # land on a class's current champion grow this cache (quirk preserved).
    champion_area = np.zeros((max_class + 1,), dtype=np.uint32)

    regions = cc_host.regionprops(comp_map, label_image)
    regions.sort(key=lambda r: r.area)
    pos_of_label = {r.label: i for i, r in enumerate(regions)}

    # Current bounding window per component (half-open), unioned on merges so
    # the dilated-border search always covers the component's full extent.
    ndim = label_image.ndim
    box_lo = {r.label: np.asarray(r.bbox[:ndim]) for r in regions}
    box_hi = {r.label: np.asarray(r.bbox[ndim:]) for r in regions}

    # LUT component-label -> output class; only each class's largest
    # component keeps its class, everything else starts at 0.
    class_of_comp = np.zeros((len(regions) + 1,), dtype=np.uint8)
    for r in regions:
        v = int(r.max_intensity)
        if r.area > champion_area[v]:
            champion_area[v] = r.area
            class_of_comp[r.label] = v

    merged_any = False
    for r in tqdm(regions, disable=disable_tqdm, desc="component merge"):
        v = int(r.max_intensity)
        if (r.area < champion_area[v] or v in spare) and r.area >= skip_below:
            lo, hi = _expand_box(box_lo[r.label], box_hi[r.label], label_image.shape)
            window = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
            sub = comp_map[window]
            rmask = sub == r.label
            dil = ndimage.binary_dilation(rmask)
            # Vote among component labels under the dilated footprint; the
            # neighbor with the widest shared border wins, ties by first
            # occurrence in ascending label order.
            neighbours, counts = np.unique(sub[dil], return_counts=True)
            merge_target = r.label
            best_border = 0
            moved_area = 0
            for ix, n in enumerate(neighbours):
                n = int(n)
                if (
                    n != 0
                    and n != r.label
                    and counts[ix] > best_border
                    and n not in spare
                ):
                    best_border = int(counts[ix])
                    merge_target = n
                    moved_area = r.area
            if merge_target != r.label:
                merged_any = True
                sub[rmask] = merge_target  # writes through into comp_map
                box_lo[merge_target] = np.minimum(box_lo[merge_target], box_lo[r.label])
                box_hi[merge_target] = np.maximum(box_hi[merge_target], box_hi[r.label])
            target = regions[pos_of_label[merge_target]]
            if target.area == champion_area[int(target.max_intensity)]:
                champion_area[int(target.max_intensity)] += moved_area
            target.area += moved_area

    class_volume = class_of_comp[comp_map]
    class_volume[np.isin(class_volume, spare)] = 0

    outmask = np.zeros(class_volume.shape, dtype=np.uint8)

    if class_volume.shape[0] == 1:
        # Single-slice volumes keep the literal per-class path: area_closing
        # is defined on the full slice (a background component's area must be
        # measured globally, so it cannot be windowed).
        for i in np.unique(class_volume)[1:]:
            largest = cc_host.keep_largest_connected_component(class_volume == i)
            filled = cc_host.area_closing_binary(largest[0], area_threshold=64)
            outmask[filled[None]] = i
        return outmask

    # One same-value labeling pass serves every class: the components of
    # class i inside it are exactly the components of the binary mask
    # ``class_volume == i`` (same connectivity, same raster ordering), so the
    # reference's per-class largest-CC (ties → LAST maximal region,
    # cc_host.keep_largest_connected_component) reduces to an area/label scan.
    # Hole filling then runs on the champion's own bounding window — outside a
    # component's bbox its binary mask is empty, so every window-border
    # background voxel connects to the volume border through the empty
    # exterior and window holes coincide with volume holes.
    if not merged_any and not spare:
        # No merge wrote into comp_map and no spare value was zeroed out, so
        # ``class_volume`` is exactly comp_map restricted to the per-class
        # champions: two same-class champions cannot touch (they would have
        # been one component), and zeroing non-champions only grows the
        # background. The partition is therefore unchanged — reuse the first
        # labeling instead of re-labeling the volume (the relabel is the
        # dominant final-sweep cost). ``finals`` holds exactly the components
        # present in class_volume (every region ever marked as its class's
        # running champion — interim champions survive the LUT too) in
        # ascending label order (the reference's tie-break is last-max in
        # that order).
        comp_final = comp_map
        finals = sorted(
            (r for r in regions if class_of_comp[r.label]),
            key=lambda r: r.label,
        )
    else:
        comp_final = cc_host.label(class_volume)
        finals = cc_host.regionprops(comp_final, class_volume)
    champion = {}  # class -> Region; ascending-label scan keeps the LAST max
    for r in finals:
        v = int(r.max_intensity)
        cur = champion.get(v)
        if cur is None or r.area >= cur.area:
            champion[v] = r
    nd = class_volume.ndim
    for i in np.unique(class_volume)[1:]:
        r = champion[int(i)]
        window = tuple(
            slice(int(a), int(b)) for a, b in zip(r.bbox[:nd], r.bbox[nd:])
        )
        filled = cc_host.fill_holes_3d(comp_final[window] == r.label)
        outmask[window][filled] = i

    return outmask
