"""lungmask's inference pipeline in NumPy/SciPy around the float32 U-Net of
:mod:`.unet`: reorientation to LPS, ``preprocess`` (HU clip, per-slice body
mask, crop to the body's box, bilinear zoom to 256², the HU window),
``postprocessing`` (small components merged into the neighbour sharing the
widest border, each class's largest component kept, holes filled), the
nearest-neighbour paste back into each slice's box, the fused pair's
FN-fill / FP-removal rule, and the reorientation back
(lungmask ``utils.py:32-129, 272-404``, ``mask.py:153-232``).

Component labels follow skimage's: same-valued voxels joined with full
connectivity unless stated, numbered in raster order of their first voxel.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
from scipy import ndimage

from portbench.reference import unet

HU_CLIP = (-1024, 600)


def flips(direction: np.ndarray) -> tuple:
    """Array axes (z, y, x order) to flip to reach LPS; axis-aligned
    directions only."""
    d = np.asarray(direction, dtype=np.float64).reshape(3, 3)
    if not np.allclose(np.abs(d), np.eye(3)):
        raise ValueError("the reference reorients axis-aligned volumes only")
    return tuple(2 - j for j in range(3) if d[j, j] < 0)


def label(image: np.ndarray, connectivity: Optional[int] = None):
    """skimage.measure.label: multi-valued components, raster-ordered
    labels. Returns (labels int32, count)."""
    image = np.asarray(image)
    struct = ndimage.generate_binary_structure(image.ndim, connectivity or image.ndim)
    out = np.zeros(image.shape, np.int32)
    n = 0
    for v in np.unique(image):
        if v == 0:
            continue
        lab, k = ndimage.label(image == v, structure=struct)
        out[lab > 0] = lab[lab > 0] + n
        n += k
    if n == 0:
        return out, 0
    first = np.empty(n, np.int64)
    for i, sl in enumerate(ndimage.find_objects(out)):
        plane = (sl[0].start,) + tuple(sl[1:])
        sub = out[plane] == i + 1
        idx = np.unravel_index(int(np.argmax(sub)), sub.shape)
        pos = (sl[0].start,) + tuple(s.start + j for s, j in zip(sl[1:], idx))
        first[i] = np.ravel_multi_index(pos, out.shape)
    mapping = np.zeros(n + 1, np.int32)
    mapping[1 + np.argsort(first, kind="stable")] = np.arange(1, n + 1, dtype=np.int32)
    return mapping[out], n


def body_mask(img: np.ndarray) -> np.ndarray:
    """lungmask ``simple_bodymask``."""
    shape = img.shape
    small = ndimage.zoom(img, 128 / np.asarray(shape), order=0)
    m = small > -500
    m = ndimage.binary_closing(m)
    m = ndimage.binary_fill_holes(m, structure=np.ones((3, 3))).astype(int)
    m = ndimage.binary_erosion(m, iterations=2)
    lab, n = label(m.astype(int), connectivity=1)
    if n > 0:
        areas = np.bincount(lab.ravel(), minlength=n + 1)[1:]
        m = lab == int(np.argmax(areas)) + 1
        m = ndimage.binary_dilation(m, iterations=2)
    return ndimage.zoom(m, np.asarray(shape) / 128, order=0)


def crop_and_resize(img: np.ndarray, size: int = 256):
    """lungmask ``crop_and_resize``: the box of the first body component,
    cropped and zoomed bilinearly (an integer image stays integer)."""
    bmask = body_mask(img)
    lab, n = label(bmask)
    if n > 0:
        sl = ndimage.find_objects((lab == 1).astype(np.int8))[0]
        box = np.asarray([sl[0].start, sl[1].start, sl[0].stop, sl[1].stop])
    else:
        box = np.asarray([0, 0, img.shape[0], img.shape[1]])
    crop = img[box[0]:box[2], box[1]:box[3]]
    return ndimage.zoom(crop, np.asarray([size, size]) / np.asarray(crop.shape), order=1), box


def preprocess(volume: np.ndarray, size: int = 256):
    """→ (normalized float64 slices (N, size, size), boxes (N, 4))."""
    clipped = np.clip(volume, *HU_CLIP)
    out = [crop_and_resize(s, size) for s in clipped]
    slices = np.asarray([o[0] for o in out], dtype=np.float64)
    slices[slices > 600] = 600
    return (slices + 1024) / 1624, np.asarray([o[1] for o in out])


def normalized_slices(volume: np.ndarray, direction: np.ndarray, start: int, stop: int,
                      size: int = 256) -> np.ndarray:
    """The normalized slices ``start:stop`` of ``volume`` reoriented to LPS
    (``preprocess`` works slice by slice), float64 (n, size, size)."""
    axes = flips(direction)
    lps = np.flip(volume, axes) if axes else volume
    return preprocess(np.ascontiguousarray(lps[start:stop]), size)[0]


def _bbox(lo, hi, shape, margin=2):
    return tuple(slice(max(int(a) - margin, 0), min(int(b) + margin, n))
                 for a, b, n in zip(lo, hi, shape))


def _keep_largest(mask: np.ndarray) -> np.ndarray:
    lab, n = label(mask)
    if n == 0:
        return np.zeros(mask.shape, bool)
    areas = np.bincount(lab.ravel(), minlength=n + 1)[1:]
    return lab == int(np.argsort(areas, kind="stable")[-1]) + 1


def _area_closing(mask2d: np.ndarray, area: int = 64) -> np.ndarray:
    lab, n = ndimage.label(mask2d == 0)
    if n == 0:
        return mask2d.astype(bool)
    small = np.zeros(n + 1, bool)
    small[1:] = np.bincount(lab.ravel(), minlength=n + 1)[1:] < area
    return mask2d.astype(bool) | small[lab]


def postprocessing(label_image: np.ndarray, spare: Sequence[int] = (), skip_below: int = 3
                   ) -> np.ndarray:
    """lungmask ``postprocessing`` (``utils.py:272-358``), each region's
    work done inside its current bounding box."""
    label_image = np.asarray(label_image)
    spare = list(spare)
    regionmask, n = label(label_image)
    maxsub = np.zeros(int(label_image.max()) + 1, np.int64)
    objects = ndimage.find_objects(regionmask)
    areas = np.bincount(regionmask.ravel(), minlength=n + 1)
    values = ndimage.maximum(label_image, regionmask, np.arange(1, n + 1)) if n else []
    regions = []
    for lbl, sl, value in zip(range(1, n + 1), objects, values):
        regions.append({"label": lbl, "area": int(areas[lbl]), "value": int(value),
                        "lo": np.asarray([s.start for s in sl]),
                        "hi": np.asarray([s.stop for s in sl])})
    regions.sort(key=lambda r: r["area"])
    by_label = {r["label"]: r for r in regions}
    lobemap = np.zeros(n + 1, np.uint8)
    for r in regions:
        if r["area"] > maxsub[r["value"]]:
            maxsub[r["value"]] = r["area"]
            lobemap[r["label"]] = r["value"]
    for r in regions:
        v = r["value"]
        if (r["area"] < maxsub[v] or v in spare) and r["area"] >= skip_below:
            window = _bbox(r["lo"], r["hi"], label_image.shape)
            sub = regionmask[window]
            own = sub == r["label"]
            neighbours, counts = np.unique(sub[ndimage.binary_dilation(own)], return_counts=True)
            mapto, best, moved = r["label"], 0, 0
            for nb, c in zip(neighbours, counts):
                nb = int(nb)
                if nb != 0 and nb != r["label"] and c > best and nb not in spare:
                    best, mapto, moved = int(c), nb, r["area"]
            if mapto != r["label"]:
                sub[own] = mapto
                t = by_label[mapto]
                t["lo"], t["hi"] = np.minimum(t["lo"], r["lo"]), np.maximum(t["hi"], r["hi"])
            t = by_label[mapto]
            if t["area"] == maxsub[t["value"]]:
                maxsub[t["value"]] += moved
            t["area"] += moved
    mapped = lobemap[regionmask]
    mapped[np.isin(mapped, spare)] = 0
    out = np.zeros(mapped.shape, np.uint8)
    for i in np.unique(mapped)[1:]:
        largest = _keep_largest(mapped == i)
        if mapped.shape[0] == 1:
            filled = _area_closing(largest[0])[None]
        else:
            filled = ndimage.binary_fill_holes(largest)
        out[filled] = i
    return out


def paste(masks: np.ndarray, boxes: np.ndarray, shape) -> np.ndarray:
    """lungmask ``reshape_mask`` per slice: nearest zoom into the box."""
    out = np.zeros((masks.shape[0],) + tuple(shape), np.uint8)
    for i, (m, b) in enumerate(zip(masks, boxes)):
        hw = np.asarray([b[2] - b[0], b[3] - b[1]])
        out[i, b[0]:b[2], b[1]:b[3]] = ndimage.zoom(m, hw / np.asarray(m.shape), order=0)
    return out


def fuse(base: np.ndarray, fill: np.ndarray) -> np.ndarray:
    """lungmask ``mask.py:223-232``: FN fill from the fill model, FP
    removal where it sees no lung, then postprocessing with the fill marker
    as spare."""
    res = base.copy()
    spare = int(res.max()) + 1
    res[np.logical_and(res == 0, fill > 0)] = spare
    res[fill == 0] = 0
    return postprocessing(res, spare=[spare])


def class_maps(volume: np.ndarray, direction: np.ndarray, models: List[dict], device,
               quant: unet.Quant = None):
    """Reorientation to LPS, preprocessing and each model's (base, fill)
    class map: ([uint8 (N, 256, 256)], boxes (N, 4), the LPS slice shape)."""
    axes = flips(direction)
    lps = np.flip(volume, axes) if axes else volume
    slices, boxes = preprocess(np.ascontiguousarray(lps))
    maps = []
    for flat in models:
        p = unet.tensors(flat, device)
        maps.append(unet.argmax(p, slices, device, quant=quant))
        del p
    return maps, boxes, lps.shape[1:]


def finish(maps: List[np.ndarray], boxes: np.ndarray, shape, direction: np.ndarray) -> np.ndarray:
    """Each class map postprocessed, pasted back into its boxes and
    reoriented to the input's axes, then the fused pair's rule: the mask."""
    axes = flips(direction)
    masks = []
    for pred in maps:
        m = paste(postprocessing(pred), boxes, shape)
        masks.append(np.ascontiguousarray(np.flip(m, axes)) if axes else m)
    return masks[0] if len(masks) == 1 else fuse(masks[0], masks[1])


def segment(volume: np.ndarray, direction: np.ndarray, models: List[dict], device,
            quant: unet.Quant = None) -> np.ndarray:
    """The whole reference ``apply`` of ``volume`` (z, y, x) under one model
    or the fused pair (base, fill), each a flat JAX-layout tree."""
    return finish(*class_maps(volume, direction, models, device, quant), direction)
