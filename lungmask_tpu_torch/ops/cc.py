"""Batched connected components (counterpart of ``lungmask_tpu.ops.cc``): the
bodymask chain and the crop boxes label ``(N, H, W)`` planes, the device
postprocessing labels whole ``(N, H, W)`` class maps in 3-D.

Labels: every foreground voxel starts with its raster linear index + 1
within its image (the last ``rank`` axes); only neighbours of the same
value connect (a bool image is one value). Each round of the fixpoint

1. takes the minimum over the structuring element's same-value neighbours,
2. spreads the minimum of every same-value run along each axis to the whole
   run (:func:`morphology.run_ids`: a cumsum of run starts, one
   ``scatter_reduce`` and one gather per axis),
3. jumps pointers once (``label ← label[label − 1]``; the voxel a label names
   is in the same component and its own label is no larger),

so rounds count the bends of a component, not its diameter. The JAX package
avoided the pointer jump only because TPU gathers were slow; on CUDA it is
one cheap gather. Exactness: labels only decrease, every label is always the
index + 1 of a voxel of the same component, and at the fixpoint no two
connected neighbours disagree, so a component carries the smallest index it
holds — exactly the JAX package's ``cc.label`` output.

The region helpers (areas, largest component with the FIRST component
winning a tie, bounding boxes) reduce per plane.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from lungmask_tpu_torch.ops.morphology import (
    neighbor_offsets,
    run_ids,
    shift_by,
    shift_slices,
    spare_ids,
    unit_offset,
)

_BIG = 2**31 - 1


def _image_size(x: torch.Tensor, rank: int) -> int:
    size = math.prod(x.shape[x.ndim - rank :])
    if size >= _BIG:
        raise ValueError(f"an image of {size} voxels overflows the int32 labels")
    return size


def label_rounds(
    image: torch.Tensor, connectivity: Optional[int] = None, rank: int = 2
) -> Tuple[torch.Tensor, int]:
    """:func:`label` and the number of fixpoint rounds it ran (one host
    synchronisation each)."""
    if connectivity is None:
        connectivity = rank
    if connectivity not in (1, rank):
        raise NotImplementedError("connectivity must be 1 or rank")
    offs = neighbor_offsets(rank, "cross" if connectivity == 1 else "full")
    binary = image.dtype == torch.bool
    fg = image if binary else image != 0
    lead = image.ndim - rank
    size = _image_size(image, rank)

    def same(off):
        """Where the neighbour at ``−off`` is foreground of the same value."""
        ok = fg & shift_by(fg, off)
        return ok if binary else ok & (image == shift_by(image, off))

    # Fixed for the whole fixpoint: the connections and the runs.
    links = [(shift_slices(image.shape, off), same(off)) for off in offs]
    run_axes = [
        run_ids(fg & ~same(unit_offset(image.ndim, a)), a)
        for a in range(lead, image.ndim)
        if image.shape[a] > 1
    ]
    spare = spare_ids(fg)
    big = torch.full((), _BIG, dtype=torch.int32, device=image.device)

    def propagate(labels):
        out = labels.clone()
        for (dst, src), ok in links:
            out[dst] = torch.minimum(out[dst], torch.where(ok[dst], labels[src], big))
        return out

    def sweep(labels):
        for ids in run_axes:
            low = torch.full((2 * labels.numel(),), _BIG, dtype=torch.int32, device=labels.device)
            low.scatter_reduce_(
                0, torch.where(fg, ids, spare).view(-1), labels.reshape(-1), "amin"
            )
            labels = torch.where(fg, low[ids], 0)
        return labels

    def jump(labels):
        flat = labels.view(-1, size)
        jumped = torch.gather(flat, 1, (flat.long() - 1).clamp_(min=0))
        return torch.where(flat > 0, torch.minimum(flat, jumped), 0).view(labels.shape)

    lin = torch.arange(1, size + 1, dtype=torch.int32, device=image.device)
    labels = sweep(torch.where(fg, lin.view(image.shape[lead:]), 0))
    rounds = 0
    while True:
        rounds += 1
        new = jump(sweep(propagate(labels)))
        if torch.equal(new, labels):
            return labels, rounds
        labels = new


def label(
    image: torch.Tensor, connectivity: Optional[int] = None, rank: int = 2
) -> torch.Tensor:
    """Connected components of each image (the last ``rank`` axes) of a bool
    or integer tensor: int32 labels, background (0 / False) 0, component
    label = raster-first linear index + 1 within the image; an integer image
    connects only neighbours of the same value. ``connectivity`` 1 is the
    cross (4 / 6 neighbours); ``rank`` (the default, as skimage's
    ``connectivity=ndim``) the full 8 / 26."""
    return label_rounds(image, connectivity, rank)[0]


def areas_by_root(labels: torch.Tensor, rank: int = 2) -> torch.Tensor:
    """Component areas of each image (the last ``rank`` axes) indexed by root
    label: ``(*leading, size + 1)`` int32, index 0 counting background."""
    size = _image_size(labels, rank)
    lead = labels.shape[: labels.ndim - rank]
    flat = labels.reshape(-1, size).long()
    areas = torch.zeros((flat.shape[0], size + 1), dtype=torch.int32, device=labels.device)
    areas.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    return areas.view(*lead, size + 1)


def largest_component_mask(labels: torch.Tensor) -> torch.Tensor:
    """Bool mask of each plane's largest component; an area tie goes to the
    scan-order-FIRST component (smallest root), as ``np.argmax`` over skimage
    regions in the reference's simple_bodymask (lungmask/utils.py:78). An
    all-background plane gives an all-False mask."""
    areas = areas_by_root(labels)
    areas[:, 0] = 0
    best = torch.argmax(areas, dim=1)  # the first maximal index on ties
    best = best.to(labels.dtype).view(-1, 1, 1)
    # All-background plane: argmax lands on root 0, which would select the
    # background — the best > 0 guard keeps the documented all-False.
    return (labels == best) & (best > 0)


def bbox_of_mask(mask: torch.Tensor) -> torch.Tensor:
    """Tight half-open box ``(r0, c0, r1, c1)`` of each plane's mask as
    ``(N, 4)`` int32, the full plane when the mask is empty (the reference's
    fallback, lungmask/utils.py:103-106)."""
    n, h, w = mask.shape
    rows = mask.any(dim=2)
    cols = mask.any(dim=1)
    ridx = torch.arange(h, dtype=torch.int32, device=mask.device)
    cidx = torch.arange(w, dtype=torch.int32, device=mask.device)
    big = 1 << 30
    r0 = torch.where(rows, ridx, big).amin(dim=1)
    r1 = torch.where(rows, ridx, -1).amax(dim=1) + 1
    c0 = torch.where(cols, cidx, big).amin(dim=1)
    c1 = torch.where(cols, cidx, -1).amax(dim=1) + 1
    box = torch.stack([r0, c0, r1, c1], dim=1)
    full = torch.tensor([0, 0, h, w], dtype=torch.int32, device=mask.device)
    empty = ~rows.any(dim=1, keepdim=True)
    return torch.where(empty, full, box).to(torch.int32)


def first_component_bbox(labels: torch.Tensor) -> torch.Tensor:
    """Box of each plane's scan-order-first component (smallest root) — the
    reference's ``reg[0].bbox`` (lungmask/utils.py:102-104), with the
    full-plane fallback."""
    pos = torch.where(labels > 0, labels, 1 << 30)
    first = pos.amin(dim=(1, 2), keepdim=True)
    return bbox_of_mask(labels == first)
