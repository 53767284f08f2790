"""Batched 2-D binary morphology on ``(N, H, W)`` bool tensors, scipy-exact
(counterpart of ``lungmask_tpu.ops.morphology`` for the bodymask chain).

scipy semantics replicated:

* structures: ``"cross"`` (4-neighbourhood, scipy's default
  ``generate_binary_structure(2, 1)``) and ``"full"`` (3×3 ones);
* ``border_value=0`` for erosion and dilation: out-of-bounds neighbours read
  as 0, so erosion eats the border and dilation brings nothing in
  (zero-filled shifts);
* ``binary_closing`` = dilation then erosion with the same structure;
* ``binary_fill_holes`` = flood the complement from the image border with the
  structure until nothing changes; the unreached complement is the holes.

Every function works on the last two axes, one plane per leading index, and
runs on whatever device its input lies on.
"""

from __future__ import annotations

import torch

_OFFSETS = {
    "cross": ((1, 0), (-1, 0), (0, 1), (0, -1)),
    "full": ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)),
}


def _offsets(structure: str):
    try:
        return _OFFSETS[structure]
    except KeyError:
        raise ValueError(f"unknown structure {structure!r}") from None


def shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[..., y, x] = x[..., y - dy, x - dx]``, 0 where that falls outside
    the plane (the JAX package's zero-filled ``_shift`` convention)."""
    h, w = x.shape[-2:]
    out = torch.zeros_like(x)
    out[..., max(dy, 0) : h + min(dy, 0), max(dx, 0) : w + min(dx, 0)] = x[
        ..., max(-dy, 0) : h + min(-dy, 0), max(-dx, 0) : w + min(-dx, 0)
    ]
    return out


def binary_dilation(
    x: torch.Tensor, structure: str = "cross", iterations: int = 1
) -> torch.Tensor:
    x = x.bool()
    offs = _offsets(structure)
    for _ in range(iterations):
        out = x.clone()
        for dy, dx in offs:
            out |= shift(x, dy, dx)
        x = out
    return x


def binary_erosion(
    x: torch.Tensor, structure: str = "cross", iterations: int = 1
) -> torch.Tensor:
    x = x.bool()
    offs = _offsets(structure)
    for _ in range(iterations):
        out = x.clone()
        for dy, dx in offs:
            out &= shift(x, dy, dx)
        x = out
    return x


def binary_closing(x: torch.Tensor, structure: str = "cross") -> torch.Tensor:
    return binary_erosion(binary_dilation(x, structure), structure)


def binary_fill_holes(x: torch.Tensor, structure: str = "cross") -> torch.Tensor:
    """Fill holes not reachable from the border (scipy binary_fill_holes).

    The bodymask calls this with ``structure="full"`` (the reference's
    ``np.ones((3, 3))``, lungmask/utils.py:71). Plain fixpoint: one masked
    dilation of the border-seeded reach per round until no plane changes.
    """
    x = x.bool()
    outside = ~x
    border = torch.zeros_like(outside)
    border[..., 0, :] = True
    border[..., -1, :] = True
    border[..., :, 0] = True
    border[..., :, -1] = True
    reached = border & outside
    while True:
        grown = binary_dilation(reached, structure) & outside
        if torch.equal(grown, reached):
            break
        reached = grown
    return x | (outside & ~reached)
