"""Batched binary morphology on bool tensors, scipy-exact (counterpart of
``lungmask_tpu.ops.morphology``).

Every function works on images in the last axes of its input, one image
per leading index, and runs on whatever device its input lies on: dilation
and hole filling on the last ``rank`` axes (2 for the bodymask's
``(N, H, W)`` planes, 3 for the device postprocessing's volumes), erosion
and closing on planes (the bodymask's only).

scipy semantics replicated:

* structures: ``"cross"`` (``generate_binary_structure(rank, 1)``: 4
  neighbours in 2-D, 6 in 3-D) and ``"full"`` (all 3^rank − 1 neighbours);
* ``border_value=0`` for erosion and dilation: out-of-bounds neighbours read
  as 0, so erosion eats the border and dilation brings nothing in
  (zero-filled shifts);
* ``binary_closing`` = dilation then erosion with the same structure;
* ``binary_fill_holes`` = flood the complement from the image border with the
  structure until nothing changes; the unreached complement is the holes.
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import torch


def neighbor_offsets(rank: int, structure: str) -> Tuple[Tuple[int, ...], ...]:
    """Offsets (centre excluded) of the structuring element, in the JAX
    package's order."""
    if structure == "cross":
        return tuple(
            tuple(d if a == axis else 0 for a in range(rank))
            for axis in range(rank)
            for d in (-1, 1)
        )
    if structure == "full":
        return tuple(o for o in itertools.product((-1, 0, 1), repeat=rank) if any(o))
    raise ValueError(f"unknown structure {structure!r}")


def shift_slices(shape: Sequence[int], off: Sequence[int]):
    """(dst, src) index tuples with ``dst`` position i ↔ ``src`` position
    i − off over the last ``len(off)`` axes of ``shape``."""
    lead = len(shape) - len(off)
    dst, src = [slice(None)] * len(shape), [slice(None)] * len(shape)
    for a, d in enumerate(off):
        n = shape[lead + a]
        dst[lead + a] = slice(max(d, 0), n + min(d, 0))
        src[lead + a] = slice(max(-d, 0), n + min(-d, 0))
    return tuple(dst), tuple(src)


def shift_by(x: torch.Tensor, off: Sequence[int]) -> torch.Tensor:
    """``out[..., i] = x[..., i − off]`` over the last ``len(off)`` axes, 0
    where that falls outside (the JAX package's zero-filled ``_shift``
    convention, one axis after another)."""
    dst, src = shift_slices(x.shape, off)
    out = torch.zeros_like(x)
    out[dst] = x[src]
    return out


def unit_offset(ndim: int, dim: int) -> Tuple[int, ...]:
    """The :func:`shift_by` offset that moves axis ``dim`` (of ``ndim``) by
    one and no other."""
    return (1,) + (0,) * (ndim - 1 - dim)


def binary_dilation(
    x: torch.Tensor, structure: str = "cross", iterations: int = 1, rank: int = 2
) -> torch.Tensor:
    x = x.bool()
    offs = neighbor_offsets(rank, structure)
    for _ in range(iterations):
        out = x.clone()
        for off in offs:
            out |= shift_by(x, off)
        x = out
    return x


def binary_erosion(
    x: torch.Tensor, structure: str = "cross", iterations: int = 1
) -> torch.Tensor:
    x = x.bool()
    offs = neighbor_offsets(2, structure)
    for _ in range(iterations):
        out = x.clone()
        for off in offs:
            out &= shift_by(x, off)
        x = out
    return x


def binary_closing(x: torch.Tensor, structure: str = "cross") -> torch.Tensor:
    return binary_erosion(binary_dilation(x, structure), structure)


def run_ids(starts: torch.Tensor, dim: int) -> torch.Tensor:
    """Ids of the runs along ``dim`` that begin where ``starts`` is True and
    go on until the next start or the first position outside every run,
    unique over the whole tensor: int64 in ``[0, numel)``, the running count
    of starts along each line (0-based) plus the line's index × its length
    (a line of length n holds at most n starts, so the ids of two lines
    never meet). Positions outside every run carry an id of no meaning."""
    n = starts.shape[dim]
    ids = torch.cumsum(starts, dim=dim, dtype=torch.int64) - 1
    lines = torch.arange(starts.numel() // max(n, 1), device=starts.device, dtype=torch.int64)
    shape = list(starts.shape)
    shape[dim] = 1
    return ids.clamp_(min=0) + (lines * n).view(shape)


def run_starts(inside: torch.Tensor, dim: int) -> torch.Tensor:
    """Starts of the maximal runs of ``inside`` along ``dim``."""
    return inside & ~shift_by(inside, unit_offset(inside.ndim, dim))


def spare_ids(x: torch.Tensor) -> torch.Tensor:
    """``numel + linear index`` per position: a slot of its own past every
    run id, where a position that takes no part in a run reduction writes
    (one slot each, so no two writers meet there)."""
    n = x.numel()
    return torch.arange(n, 2 * n, dtype=torch.int64, device=x.device).view(x.shape)


def run_any(value: torch.Tensor, ids: torch.Tensor, spare: torch.Tensor) -> torch.Tensor:
    """Per position, whether any position of its run holds ``value``
    (``value`` only inside runs). Every writer writes True, so the result
    does not depend on the order of the writes."""
    hit = torch.zeros(2 * ids.numel(), dtype=torch.bool, device=ids.device)
    hit[torch.where(value, ids, spare)] = True
    return hit[ids]


def fill_holes_rounds(
    x: torch.Tensor, structure: str = "cross", rank: int = 2
) -> Tuple[torch.Tensor, int]:
    """:func:`binary_fill_holes` and the number of fixpoint rounds it ran
    (one host synchronisation each)."""
    x = x.bool()
    outside = ~x
    lead = x.ndim - rank
    seed = torch.zeros_like(outside)
    for a in range(lead, x.ndim):
        seed.narrow(a, 0, 1).fill_(True)
        seed.narrow(a, x.shape[a] - 1, 1).fill_(True)
    offs = neighbor_offsets(rank, structure)
    # Background runs along every axis, fixed for the whole flood.
    run_axes = [
        run_ids(run_starts(outside, a), a) for a in range(lead, x.ndim) if x.shape[a] > 1
    ]
    spare = spare_ids(x)

    def sweep(reached):
        for ids in run_axes:
            reached = outside & run_any(reached, ids, spare)
        return reached

    reached = sweep(seed & outside)
    rounds = 0
    while True:
        rounds += 1
        grown = binary_dilation(reached, structure, rank=rank) & outside
        grown = sweep(grown)
        if torch.equal(grown, reached):
            return x | (outside & ~reached), rounds
        reached = grown


def binary_fill_holes(x: torch.Tensor, structure: str = "cross", rank: int = 2) -> torch.Tensor:
    """Fill holes not reachable from the border (scipy binary_fill_holes).

    The bodymask calls this with ``structure="full"`` (the reference's
    ``np.ones((3, 3))``, lungmask/utils.py:71); the 3-D device postprocessing
    with the cross (fill_voids semantics, utils.py:352).

    Span flood, as the JAX package's: each round takes one structuring-element
    step of the border-seeded reach inside the complement, then spreads it
    along every axis over whole background runs (:func:`run_ids`, a cumsum of
    run starts, then one scatter and one gather per axis), so the rounds count the
    bends of a cavity's geometry, not its diameter. The result is defined by
    the input alone: any exact fixpoint gives scipy's output bit for bit.
    """
    return fill_holes_rounds(x, structure, rank)[0]
