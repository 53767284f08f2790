"""Device-side volume postprocessing, simplified semantics (counterpart of
``lungmask_tpu.transforms.postprocess_device``).

The exact reference postprocessing (``transforms/postprocess.py``) merges
small regions into neighbours in ascending-area order, each merge changing
what later decisions read (reference lungmask/utils.py:310-339); it stays on
the host. This module is the device-resident alternative for the throughput
lanes: **per-label largest 3-D connected component + 3-D hole filling**, the
final cleanup stage of the reference pipeline (utils.py:344-357), run in
plain torch on the class map's device. It skips the small-region merge.

**Accuracy contract** (the JAX package's, which this module reproduces bit
for bit): the output differs from the exact path only on voxels of
non-champion components with area ≥ skip_below — the exact path remaps them
into the adjacent label with the widest shared border, this path removes
them (plus any holes such a merge would have sealed, and champion shifts
where a merge grows a smaller component past its label's largest). With the
crafted intensity-band weights, whose classes are HU bands rather than
laterality, a merge can move a whole lung between classes, so device-vs-exact
Dice can be low there; real R231/LTRCLobes predictions move only small
satellites. Bit-parity workloads keep ``postprocessing_mode="exact"``.

Device memory at 600 slices × 256² (39.3 M voxels), from the shapes: the
int32 labels 157 MB and the int32 areas 157 MB; while labelling, the 26
fixed same-value link masks (bool, 1.0 GB) and three int64 run-id maps plus
one int64 spare-slot map (1.26 GB); the (C − 1) kept masks 39 MB each (5 for
LTRCLobes) and, while filling, the same four int64 maps over that stack
(6.3 GB for LTRCLobes, 2.5 GB for R231).
"""

from __future__ import annotations

from typing import Optional

import torch

from lungmask_tpu_torch.ops import cc, morphology
from lungmask_tpu_torch.ops.packing import pack_bits


def _largest_cc_per_class(pred: torch.Tensor, n_classes: int, stats: dict) -> torch.Tensor:
    """(n_classes − 1, N, H, W) bool stack: the largest 26-connected
    component of each non-zero class, from ONE labeling of the multi-class
    map (``cc.label`` connects only same-value neighbours, so each class's
    components are those of its own binary mask).

    A root label r is the component's first voxel's linear index + 1, so
    ``pred.flat[r − 1]`` is the component's class: the class lookup is pred
    flattened with a zero in front. Non-root entries there mean nothing, but
    their area is 0, so they never win. The scan-order-LAST component wins an
    area tie (reference utils.py:402, ``np.argsort(areas)[-1]``): torch's
    argmax returns the first maximum, so it runs over the flipped areas, as
    the JAX package's does.
    """
    labels, stats["label_rounds"] = cc.label_rounds(pred, rank=3)
    areas = cc.areas_by_root(labels, rank=3)
    areas[0] = 0
    root_class = torch.cat([pred.new_zeros(1), pred.reshape(-1)])
    n = areas.shape[0]
    keeps = []
    for v in range(1, n_classes):
        areas_v = torch.where(root_class == v, areas, 0)
        best = n - 1 - torch.argmax(areas_v.flip(0))
        # Empty class: every masked area is 0 and argmax lands on a root that
        # may belong to another class — gate on the winner's area.
        keeps.append((labels == best) & (areas_v[best] > 0))
    return torch.stack(keeps)


def postprocess_device(
    pred: torch.Tensor, n_classes: int, stats: Optional[dict] = None
) -> torch.Tensor:
    """(N, H, W) uint8 class map → cleaned uint8 map on the same device.

    For each non-zero label: keep its largest 3-D connected component and
    fill that component's holes (6-connected background flood, fill_voids
    semantics); later labels overwrite earlier ones where filled components
    overlap (the reference's write order, utils.py:354-356). One labeling
    covers every class; the per-class hole fills run as one batched flood
    over the (C − 1, N, H, W) stack, so the rounds are the maximum over
    classes, not the sum. ``stats``, when given, receives the fixpoint round
    counts ``label_rounds`` and ``fill_rounds``.
    """
    stats = {} if stats is None else stats
    keeps = _largest_cc_per_class(pred, n_classes, stats)
    filled, stats["fill_rounds"] = morphology.fill_holes_rounds(keeps, "cross", rank=3)
    out = torch.zeros_like(pred)
    for i, v in enumerate(range(1, n_classes)):
        out = torch.where(filled[i], torch.tensor(v, dtype=pred.dtype, device=pred.device), out)
    return out


def postprocess_device_packed2(
    pred: torch.Tensor, n_classes: int, stats: Optional[dict] = None
) -> torch.Tensor:
    """:func:`postprocess_device` crumb-packed on the device (four 2-bit
    pixels per byte, (N, H, W/4) out; the engine's bit order) for a
    quarter-size download. Valid for ≤ 4 classes with W % 4 == 0."""
    if n_classes > 4 or pred.shape[-1] % 4:
        raise ValueError(
            f"crumb packing needs ≤ 4 classes and a width divisible by 4, got "
            f"{n_classes} classes and width {pred.shape[-1]}"
        )
    return pack_bits(postprocess_device(pred, n_classes, stats), 2)
