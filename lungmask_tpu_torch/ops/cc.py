"""Batched 2-D connected components on ``(N, H, W)`` tensors (counterpart of
``lungmask_tpu.ops.cc`` for the bodymask chain and the crop boxes).

Labels: every foreground pixel starts with its raster linear index + 1 within
its plane; a fixpoint of neighbour-minimum propagation plus one pointer jump
per round (``label ← label[label − 1]``) leaves each component labelled with
its raster-first pixel's index + 1, which is exactly the JAX package's
``cc.label`` output. Exactness: labels only decrease, every label is always
the index + 1 of a pixel of the same component, and at the fixpoint no two
neighbours disagree, so a component carries the smallest index it holds.

The region helpers (areas, largest component with the FIRST component
winning a tie, bounding boxes) reduce per plane.
"""

from __future__ import annotations

from typing import Optional

import torch

from lungmask_tpu_torch.ops.morphology import _offsets, shift

_BIG = 2**31 - 1


def label(mask: torch.Tensor, connectivity: Optional[int] = None) -> torch.Tensor:
    """Connected components of each ``(H, W)`` plane of a bool ``(N, H, W)``
    tensor: int32 labels, background 0, component label = raster-first
    linear index + 1. ``connectivity`` 1 is the 4-neighbourhood; 2 (the
    default, as skimage's ``connectivity=ndim``) the 8-neighbourhood."""
    if connectivity is None:
        connectivity = 2
    if connectivity not in (1, 2):
        raise NotImplementedError("connectivity must be 1 or 2")
    offs = _offsets("cross" if connectivity == 1 else "full")
    fg = mask.bool()
    n, h, w = fg.shape
    lin = torch.arange(1, h * w + 1, dtype=torch.int32, device=fg.device).view(1, h, w)
    labels = torch.where(fg, lin, 0)
    while True:
        out = labels
        for dy, dx in offs:
            s = shift(labels, dy, dx)
            out = torch.minimum(out, torch.where(s > 0, s, _BIG))
        flat = torch.where(fg, out, 0).view(n, h * w)
        # Pointer jump: the pixel a label names is in the same component and
        # its own label is no larger, so this only speeds convergence.
        jumped = torch.gather(flat, 1, (flat.long() - 1).clamp_(min=0))
        new = torch.where(flat > 0, torch.minimum(flat, jumped), 0).view(n, h, w)
        if torch.equal(new, labels):
            return labels
        labels = new


def areas_by_root(labels: torch.Tensor) -> torch.Tensor:
    """Per-plane component areas indexed by root label: ``(N, H*W + 1)``
    int32; index 0 counts background."""
    n = labels.shape[0]
    flat = labels.reshape(n, -1).long()
    areas = torch.zeros((n, flat.shape[1] + 1), dtype=torch.int32, device=labels.device)
    return areas.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))


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
