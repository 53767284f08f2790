"""``metrics.compare_masks`` and ``dice`` of the port against the JAX
package's. Tolerance: none — the counts are integers and every derived
number is computed by the same float64 formula, so they must be equal."""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from lungmask_tpu import metrics as jmetrics
from lungmask_tpu_torch import metrics


def _pair(seed: int, n_classes: int, shape=(6, 20, 24)):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, n_classes, shape).astype(np.uint8)
    pred = ref.copy()
    flip = rng.random(shape) < 0.2
    pred[flip] = rng.integers(0, n_classes, int(flip.sum()))
    return pred, ref


def _same(got, want):
    assert got.total_voxels == want.total_voxels
    assert got.voxel_accuracy == want.voxel_accuracy
    assert got.macro_dice == want.macro_dice and got.macro_iou == want.macro_iou
    assert got.per_label.keys() == want.per_label.keys()
    for v, m in want.per_label.items():
        assert vars(got.per_label[v]) == vars(m)
        assert got.per_label[v].volume_ratio == m.volume_ratio


@pytest.mark.parametrize("seed, n_classes", [(0, 3), (1, 6), (2, 2)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_compare_masks_equals_jax(seed, n_classes, as_tensor):
    pred, ref = _pair(seed, n_classes)
    want = jmetrics.compare_masks(pred, ref)
    args = (torch.from_numpy(pred), torch.from_numpy(ref)) if as_tensor else (pred, ref)
    _same(metrics.compare_masks(*args), want)
    _same(metrics.compare_masks(*args, n_classes=8), jmetrics.compare_masks(pred, ref, n_classes=8))
    assert metrics.dice(*args) == jmetrics.dice(pred, ref)
    np.testing.assert_array_equal(
        metrics.confusion_counts(pred, ref, n_classes).numpy(),
        np.asarray(jmetrics.confusion_counts(pred, ref, n_classes)),
    )


def test_absent_labels_and_empty_volumes():
    pred = np.zeros((2, 3, 3), np.uint8)
    ref = pred.copy()
    ref[0, 0, 0] = 2
    _same(metrics.compare_masks(pred, ref, n_classes=4), jmetrics.compare_masks(pred, ref, n_classes=4))
    empty = np.zeros((0, 3, 3), np.uint8)
    _same(metrics.compare_masks(empty, empty), jmetrics.compare_masks(empty, empty))


def test_compare_masks_errors():
    a = np.zeros((2, 2), np.int16)
    with pytest.raises(ValueError, match="shape mismatch"):
        metrics.compare_masks(a, np.zeros((2, 3), np.int16))
    b = a.copy()
    b[0, 0] = -1
    with pytest.raises(ValueError, match="negative labels"):
        metrics.compare_masks(b, a)
    a[0, 0] = 3
    with pytest.raises(ValueError, match="n_classes=2"):
        metrics.compare_masks(a, a, n_classes=2)
