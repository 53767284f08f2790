"""Segmentation quality metrics: Dice, IoU, volume agreement (counterpart of
``lungmask_tpu.metrics``, with the same numbers).

Per-label overlap metrics from one confusion-matrix pass over the volume
pair, on the device the masks lie on (torch tensors) or on the host (numpy
arrays); only the (n_classes)² counts come back. It is the yardstick of
device-mode against exact postprocessing.

Conventions: label 0 is background and excluded from per-label tables and
averages; a label absent from BOTH volumes scores Dice/IoU 1.0 (agreement on
absence) and is left out of the macro averages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch


def confusion_counts(pred, ref, n_classes: int) -> torch.Tensor:
    """(n_classes, n_classes) int64 confusion matrix, rows = reference
    label, columns = predicted label, on the inputs' device."""
    pred = torch.as_tensor(pred).reshape(-1).long()
    ref = torch.as_tensor(ref).reshape(-1).to(pred.device).long()
    counts = torch.bincount(ref * n_classes + pred, minlength=n_classes * n_classes)
    return counts.reshape(n_classes, n_classes)


@dataclass
class LabelMetrics:
    dice: float
    iou: float
    ref_voxels: int
    pred_voxels: int
    intersection: int

    @property
    def volume_ratio(self) -> float:
        """Predicted / reference voxel count (1.0 = same volume)."""
        if self.ref_voxels == 0:
            return float("inf") if self.pred_voxels else 1.0
        return self.pred_voxels / self.ref_voxels


@dataclass
class MaskComparison:
    per_label: Dict[int, LabelMetrics]
    voxel_accuracy: float
    total_voxels: int

    @property
    def macro_dice(self) -> float:
        """Mean foreground Dice over labels present in either volume."""
        vals = [m.dice for m in self.per_label.values() if m.ref_voxels or m.pred_voxels]
        return float(np.mean(vals)) if vals else 1.0

    @property
    def macro_iou(self) -> float:
        vals = [m.iou for m in self.per_label.values() if m.ref_voxels or m.pred_voxels]
        return float(np.mean(vals)) if vals else 1.0


def compare_masks(pred, ref, n_classes: Optional[int] = None) -> MaskComparison:
    """Per-label Dice/IoU/volume metrics between two label volumes of one
    shape (numpy arrays or torch tensors)."""
    pred, ref = torch.as_tensor(pred), torch.as_tensor(ref)
    if pred.shape != ref.shape:
        raise ValueError(f"shape mismatch: pred {tuple(pred.shape)} vs ref {tuple(ref.shape)}")
    if pred.numel():
        observed = max(int(pred.max()), int(ref.max()))
        lowest = min(int(pred.min()), int(ref.min()))
    else:
        observed = lowest = 0
    if lowest < 0:
        raise ValueError(
            f"negative labels present (min {lowest}); masks must be non-negative label maps"
        )
    if n_classes is None:
        n_classes = observed + 1
    elif observed >= n_classes:
        raise ValueError(
            f"n_classes={n_classes} but labels up to {observed} are present; "
            f"pass n_classes >= {observed + 1} (or None to infer)"
        )
    cm = confusion_counts(pred, ref, n_classes).cpu().numpy().astype(np.int64)
    per_label: Dict[int, LabelMetrics] = {}
    for v in range(1, n_classes):
        inter = int(cm[v, v])
        ref_n = int(cm[v, :].sum())
        pred_n = int(cm[:, v].sum())
        union = ref_n + pred_n - inter
        per_label[v] = LabelMetrics(
            dice=(2.0 * inter / (ref_n + pred_n)) if (ref_n + pred_n) else 1.0,
            iou=(inter / union) if union else 1.0,
            ref_voxels=ref_n,
            pred_voxels=pred_n,
            intersection=inter,
        )
    total = int(cm.sum())
    correct = int(np.trace(cm))
    return MaskComparison(
        per_label=per_label,
        voxel_accuracy=correct / total if total else 1.0,
        total_voxels=total,
    )


def dice(pred, ref) -> float:
    """Binary Dice of ``pred > 0`` vs ``ref > 0`` (lung against background,
    whatever the laterality or lobe labels)."""
    cmp = compare_masks(
        torch.as_tensor(pred) > 0, torch.as_tensor(ref) > 0, n_classes=2
    )
    return cmp.per_label[1].dice
