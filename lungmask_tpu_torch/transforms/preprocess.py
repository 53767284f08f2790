"""Device and hybrid preprocessing (counterpart of
``lungmask_tpu.transforms.preprocess``).

Device mode (:func:`preprocess`, ``preprocessing="device"``): the raw volume
is uploaded once; on its device it is clipped to [−1024, 600] HU, each slice
nearest-subsampled to 128², the bodymasks come from K1 and plain torch, the
crop boxes from them (:func:`_box_from_mask`, both of the JAX package's
branches), and the crop + scipy-exact bilinear resize + window + normalize
runs as batched gathers from a float64 host plan (``ops/resample.py``).
Only the ``(N, 4)`` boxes come down. Unlike the JAX package, no slice
padding: it only bounded the number of jit programs.

Hybrid mode (:func:`preprocess_hybrid`, the default):

1. host: nearest-subsample every slice to 128² with the exact scipy order-0
   plan, threshold at −500 HU, pack to bits (:func:`pack_bodymask_bits`);
2. device: bodymask → crop boxes (:func:`_boxes_from_packed`), through K1
   (``ops/kernels/bodymask.py``) and plain torch for the rest;
3. host: fused crop + scipy-exact float64 bilinear resize + HU window +
   normalize (native C++ core, scipy fallback), then one upload of the 256²
   stack, cast to the compute dtype on the device.

In hybrid mode, slices smaller than 128² take the strict host pipeline
(``transforms/host_pipeline.py``) instead, as the JAX package's do; its
stack is cast and uploaded the same way.

Sharded mode (:func:`preprocess_sharded`, ``preprocessing="sharded"`` with
a mesh): device mode with the raw volume split over the mesh's data axis
into slabs, each slab's boxes (K1 included) and normalized slices computed
on its own device; the stack stays in slabs (each split into bands over
its row's space devices, with ``space > 1``) for the sharded U-Net.

Every entry point computes on CUDA unless its ``device`` is ``"cpu"``
(``utils/device.resolve_device``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from lungmask_tpu_torch.ops import cc, morphology, resample
from lungmask_tpu_torch.ops.kernels.bodymask import bodymask_labels
from lungmask_tpu_torch.parallel.mesh import shard_bands, split_rows
from lungmask_tpu_torch.utils.device import resolve_device

HU_LO = -1024
HU_HI = 600
BODY_THRESHOLD = -500


def pack_bodymask_bits(volume: np.ndarray) -> np.ndarray:
    """(N, H, W) HU volume → (N, 128, 16) uint8 packed body-threshold bits.

    Order-0 subsample to 128² (scipy plan, zero-filled out-of-bounds samples —
    and 0 > −500 is *body*, the quirk the full-resolution paths inherit from
    scipy's cval=0), threshold −500 HU. Clipping to [−1024, 600] commutes with
    the gather and never changes the threshold predicate, so it is skipped.
    """
    n, h, w = volume.shape
    ridx, roob = resample._axis_plan_np(h, 128, 0)
    cidx, coob = resample._axis_plan_np(w, 128, 0)
    # One fused gather straight to (N, 128, 128).
    mask = volume[:, ridx[:, None], cidx[None, :]] > BODY_THRESHOLD
    if roob.any():
        mask[:, roob, :] = True
    if coob.any():
        mask[:, :, coob] = True
    return np.packbits(mask, axis=-1)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """scipy's integer-output cast for interpolated values: trunc(x ± 0.5)."""
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5))


def _bodymask128_from_labels(labels: torch.Tensor, eroded: torch.Tensor) -> torch.Tensor:
    """Largest-region keep + dilation ×2 given the 4-connected labels of the
    eroded masks, per plane. A plane without a region keeps its eroded mask
    (the reference's guard, lungmask/utils.py:77-80)."""
    has_region = (labels > 0).flatten(1).any(dim=1).view(-1, 1, 1)
    largest = cc.largest_component_mask(labels)
    dilated = morphology.binary_dilation(largest, iterations=2)
    return torch.where(has_region, dilated, eroded)


def _upzoom_box_tables(src: int, dst: int, device) -> torch.Tensor:
    """idx[i] = the 128-grid source index of output row i of an order-0
    upzoom, with scipy-oob rows (always trailing) replaced by the sentinel
    ``src`` so they never fall inside a box."""
    idx, oob = resample._axis_plan_np(src, dst, 0)
    idx = idx.astype(np.int32)
    idx[oob] = src
    return torch.from_numpy(idx).to(device)


def _bodymask128(smalls: torch.Tensor) -> torch.Tensor:
    """(N, 128, 128) HU → (N, 128, 128) bool bodymasks: K1, then the
    largest-region keep and dilation."""
    return _bodymask128_from_labels(*bodymask_labels(smalls))


def _box_from_mask(shape: Tuple[int, int], mask128: torch.Tensor) -> torch.Tensor:
    """(N, 4) int32 crop boxes (r0, c0, r1, c1) of (N, 128, 128) bodymasks for
    slices of ``shape``.

    The reference nearest-upzooms the bodymask, relabels it 8-connected at
    full resolution and boxes the first region (lungmask/utils.py:82,98-106).
    Slices of at least 128² (an upzoom): the first full-resolution component
    is the image of the first 128² component, so its box is the preimage
    range of the 128² box through the static zoom tables (the JAX package's
    ``_box_from_mask`` gives the argument and its one caveat, which the
    bodymask chain cannot trigger). Smaller slices (components can merge or
    vanish) take the reference's own route: an order-0 resize to the slice,
    8-connected labels per plane, the first region's box. A plane without a
    region boxes the full image.
    """
    h, w = shape
    if h < 128 or w < 128:
        full = resample.resize(mask128, (mask128.shape[0], h, w), order=0)
        return cc.first_component_bbox(cc.label(full))
    labels = cc.label(mask128)  # 8-connectivity at 128²
    box128 = cc.first_component_bbox(labels)
    ridx = _upzoom_box_tables(128, h, mask128.device)
    cidx = _upzoom_box_tables(128, w, mask128.device)
    r0 = torch.searchsorted(ridx, box128[:, 0].contiguous(), side="left")
    r1 = torch.searchsorted(ridx, (box128[:, 2] - 1).contiguous(), side="right")
    c0 = torch.searchsorted(cidx, box128[:, 1].contiguous(), side="left")
    c1 = torch.searchsorted(cidx, (box128[:, 3] - 1).contiguous(), side="right")
    mapped = torch.stack([r0, c0, r1, c1], dim=1).to(torch.int32)
    has_region = (labels > 0).flatten(1).any(dim=1, keepdim=True)
    full = torch.tensor([0, 0, h, w], dtype=torch.int32, device=mask128.device)
    return torch.where(has_region, mapped, full)


def smalls_from_packed(packed: torch.Tensor) -> torch.Tensor:
    """(N, 128, 16) packed threshold bits → (N, 128, 128) int16 HU, body ↦ 0
    (> −500) and background ↦ −1024, so the bodymask kernel runs unchanged."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    thresholded = bits.reshape(packed.shape[0], 128, 128) != 0
    return torch.where(
        thresholded,
        torch.zeros((), dtype=torch.int16, device=packed.device),
        torch.full((), HU_LO, dtype=torch.int16, device=packed.device),
    )


def _boxes_from_packed(
    packed: torch.Tensor, shape: Tuple[int, int]
) -> torch.Tensor:
    """(N, 128, 16) packed threshold bits → (N, 4) int32 crop boxes, on the
    device ``packed`` lies on."""
    return _box_from_mask(shape, _bodymask128(smalls_from_packed(packed)))


def _upload(volume: np.ndarray, device) -> torch.Tensor:
    """The raw volume on ``device`` in the type the JAX package computes in
    (it runs without 64-bit types): float volumes as float32, int16 as is,
    other integers as int32."""
    vol = np.asarray(volume)
    if np.issubdtype(vol.dtype, np.floating):
        vol = vol.astype(np.float32, copy=False)
    elif vol.dtype not in (np.int16, np.int32):
        vol = vol.astype(np.int32)
    return torch.from_numpy(np.require(vol, requirements=["C", "W"])).to(device)


def _boxes_for_volume(raw: torch.Tensor) -> torch.Tensor:
    """(N, 4) int32 crop boxes of a raw (unclipped) HU volume, on its
    device: clip, order-0 subsample to 128², bodymasks, boxes."""
    smalls = resample.resize(raw.clamp(HU_LO, HU_HI), (raw.shape[0], 128, 128), order=0)
    return _box_from_mask(tuple(raw.shape[1:]), _bodymask128(smalls))


def _crop_normalize(raw: torch.Tensor, plan, integer_input: bool) -> torch.Tensor:
    """Clip, crop + resize by ``plan``, round half away from zero for an
    integer volume (scipy's cast), window at 600 HU, ``(x + 1024) / 1624``."""
    slices = resample.apply_crop_resize(raw.clamp(HU_LO, HU_HI), plan)
    if integer_input:
        slices = _round_half_away(slices)
    return (slices.clamp(max=float(HU_HI)) + 1024.0) / 1624.0


def compute_boxes(volume: np.ndarray, device=None) -> np.ndarray:
    """Crop boxes of every slice of a (N, H, W) HU volume, computed on
    ``device`` (CUDA unless ``"cpu"``): (N, 4) int32 numpy."""
    return _boxes_for_volume(_upload(volume, resolve_device(device))).cpu().numpy()


def preprocess(
    volume: np.ndarray,
    resolution: Tuple[int, int] = (256, 256),
    compute_dtype: torch.dtype = torch.float32,
    device=None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Device preprocessing of a (N, H, W) HU volume (module docstring).

    Returns:
        normalized: (N, res, res) tensor on ``device`` (CUDA unless
            ``"cpu"``) in [0, 1], computed in float32 and cast once to
            ``compute_dtype``.
        boxes: (N, 4) int32 numpy crop boxes.
    """
    raw = _upload(volume, resolve_device(device))
    boxes = _boxes_for_volume(raw).cpu().numpy()
    plan = resample.crop_resize_plan(boxes, resolution, order=1, device=raw.device)
    normalized = _crop_normalize(raw, plan, not raw.is_floating_point())
    return normalized.to(compute_dtype), boxes


def _upload_slabs(volume: np.ndarray, mesh) -> List[torch.Tensor]:
    """The raw volume split over the mesh's data axis (``split_rows``),
    each slab uploaded to its device as :func:`_upload` does."""
    devs = mesh.data_devices
    return [_upload(volume[a:b], dev) for (a, b), dev in zip(split_rows(len(volume), len(devs)), devs)]


def _slab_boxes(raws: List[torch.Tensor]) -> np.ndarray:
    """(N, 4) int32 boxes of the slabs, each computed on its own device."""
    parts = [_boxes_for_volume(r) if r.shape[0] else None for r in raws]
    return np.concatenate([np.zeros((0, 4), np.int32) if p is None else p.cpu().numpy()
                           for p in parts])


def make_sharded_boxes_fn(mesh):
    """``boxes(volume (N, H, W) HU) → (N, 4) int32 numpy``: the slices split
    over the mesh's data axis, each slab's crop boxes (K1 included)
    computed on its own device, gathered on the host."""
    return lambda volume: _slab_boxes(_upload_slabs(np.asarray(volume), mesh))


def preprocess_sharded(
    volume: np.ndarray,
    mesh,
    resolution: Tuple[int, int] = (256, 256),
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[list, np.ndarray]:
    """:func:`preprocess` over a mesh: the raw volume split over the data
    axis (``parallel.mesh.split_rows``), each slab clipped, boxed (K1) and
    cropped + resized + normalized on its own data device, as JAX shards
    its preprocessing over ``data`` alone; with ``space > 1`` each slab is
    then split into its row's bands (``parallel.mesh.shard_bands``).

    Returns:
        normalized: one (n_d, res, res) slab per data device, in
            ``compute_dtype``, on that device; stacked, equal to
            :func:`preprocess`'s stack. With ``space > 1``, each data
            device's entry is the list of its slab's bands, band s on
            ``mesh.devices[d, s]``.
        boxes: (N, 4) int32 numpy crop boxes, equal to :func:`preprocess`'s.
    """
    raws = _upload_slabs(np.asarray(volume), mesh)
    boxes = _slab_boxes(raws)
    normalized, row = [], 0
    for raw in raws:
        n = raw.shape[0]
        plan = resample.crop_resize_plan(boxes[row : row + n], resolution, order=1,
                                         device=raw.device)
        slab = _crop_normalize(raw, plan, not raw.is_floating_point()) if n else (
            torch.zeros((0,) + tuple(resolution), device=raw.device))
        normalized.append(slab.to(compute_dtype))
        row += n
    if mesh.shape["space"] > 1:
        normalized = [shard_bands(mesh, d, slab) for d, slab in enumerate(normalized)]
    return normalized, boxes


def _crop_resize_normalize_scipy(
    volume: np.ndarray, boxes: np.ndarray, resolution: Tuple[int, int]
) -> np.ndarray:
    """scipy fallback for the host resample+normalize stage (clip → crop →
    zoom order=1 → window/scale)."""
    from scipy import ndimage

    clipped = np.clip(volume, HU_LO, HU_HI)
    out = np.empty((volume.shape[0],) + tuple(resolution), dtype=np.float32)
    target = np.asarray(resolution, dtype=np.float64)
    for i, (r0, c0, r1, c1) in enumerate(boxes):
        cropped = clipped[i, r0:r1, c0:c1]
        resized = ndimage.zoom(cropped, target / np.asarray(cropped.shape), order=1)
        resized = np.asarray(resized, dtype=np.float64)
        resized[resized > HU_HI] = HU_HI
        out[i] = (resized + 1024.0) / 1624.0
    return out


def crop_resize_normalize_host(
    volume: np.ndarray, boxes: np.ndarray, resolution: Tuple[int, int]
) -> np.ndarray:
    """Fused host crop+resize+normalize: native C++ core, scipy fallback
    (float volumes always take the scipy path)."""
    from lungmask_tpu_torch.ops import native

    out = native.crop_resize_normalize(volume, boxes, resolution)
    if out is None:
        out = _crop_resize_normalize_scipy(volume, boxes, resolution)
    return out


def preprocess_hybrid(
    volume: np.ndarray,
    resolution: Tuple[int, int] = (256, 256),
    compute_dtype: torch.dtype = torch.float32,
    device=None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Transfer-lean preprocessing of a (N, H, W) HU volume.

    Returns:
        normalized: (N, res, res) tensor on ``device`` (CUDA unless
            ``"cpu"``) in [0, 1], in
            ``compute_dtype`` (the float32 → bf16 cast rounds to nearest
            even, as the JAX host cast does).
        boxes: (N, 4) int32 numpy crop boxes.

    Slices smaller than 128² go through :func:`preprocess_host` (the JAX
    package's fallback, its ``preprocess.py:344-354``): bit for bit the
    same float64 arithmetic, with the boxes of the host bodymask.
    """
    n, h, w = volume.shape
    device = resolve_device(device)
    if h < 128 or w < 128:
        return preprocess_host(volume, resolution, compute_dtype, device)
    packed = torch.from_numpy(pack_bodymask_bits(volume)).to(device)
    boxes = _boxes_from_packed(packed, (h, w)).cpu().numpy()
    normalized = crop_resize_normalize_host(volume, boxes, resolution)
    out = torch.from_numpy(normalized).to(device).to(compute_dtype)
    return out, boxes


def preprocess_host(
    volume: np.ndarray,
    resolution: Tuple[int, int] = (256, 256),
    compute_dtype: torch.dtype = torch.float32,
    device=None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Strict host preprocessing (``preprocessing="host"``): the reference's
    per-slice scipy chain (:mod:`host_pipeline`), normalized in float64,
    rounded to float32 on the host, then uploaded to ``device`` and cast to
    ``compute_dtype`` there. Same returns as :func:`preprocess_hybrid`."""
    from lungmask_tpu_torch.transforms import host_pipeline

    slices, boxes = host_pipeline.preprocess(volume, resolution=resolution)
    normalized = host_pipeline.normalize_hu(slices).astype(np.float32)
    out = torch.from_numpy(normalized).to(resolve_device(device)).to(compute_dtype)
    return out, np.asarray(boxes)
