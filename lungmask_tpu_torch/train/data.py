"""Fine-tuning data pipeline: (volume, mask) pairs → shuffled 256² slice
batches (counterpart of ``lungmask_tpu.train.data``).

Slices go through the same preprocessing as inference with
``preprocessing="device"`` — HU clip, body-crop box, scipy-exact bilinear
resize to 256², intensity normalization — and the label masks ride the same
boxes with nearest-neighbour resampling, so fine-tuned models see the
inference-time distribution. Both are computed on ``device`` and come back
to host numpy, as in the JAX package; the shuffle draws from numpy's
``default_rng(seed)`` exactly as the JAX package's does, so both packages
see the same batches.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from lungmask_tpu_torch.ops import resample
from lungmask_tpu_torch.transforms import preprocess as prep
from lungmask_tpu_torch.utils.device import resolve_device

Pair = Tuple[np.ndarray, np.ndarray]  # (HU volume (N,H,W), label mask (N,H,W))


def slices_from_pair(
    volume: np.ndarray, mask: np.ndarray, resolution=(256, 256), device=None
) -> Tuple[np.ndarray, np.ndarray]:
    """One volume/mask pair → (images (N,256,256) f32, labels (N,256,256)
    i32), computed on ``device`` (CUDA unless ``"cpu"`` is asked for)."""
    if volume.shape != mask.shape:
        raise ValueError(f"volume {volume.shape} vs mask {mask.shape}")
    device = resolve_device(device)
    normalized, boxes = prep.preprocess(volume, resolution=resolution, device=device)
    images = normalized.cpu().numpy()
    label_plan = resample.crop_resize_plan(boxes, resolution, order=0, device=device)
    labels = resample.apply_crop_resize(
        torch.from_numpy(mask.astype(np.int32)).to(device), label_plan
    )
    return images.astype(np.float32), labels.cpu().numpy().astype(np.int32)


def iter_shuffled_batches(
    n: int,
    batch_size: int,
    gather,
    *,
    seed: int = 0,
    epochs: int = 1,
    drop_last: bool = True,
    what: str = "dataset",
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shared shuffle/epoch/drop_last loop for slice pools (``SliceDataset``
    and the memmap ``SliceStore`` differ only in how a batch is gathered).
    ``gather(idx)`` maps an index array to the yielded batch."""
    rng = np.random.default_rng(seed)
    if drop_last and n < batch_size:
        raise ValueError(
            f"batch_size={batch_size} exceeds the {what} ({n} slices); "
            "every epoch would yield zero batches — lower batch_size or "
            "pass drop_last=False"
        )
    for _ in range(epochs):
        order = rng.permutation(n)
        stop = n - (n % batch_size) if drop_last else n
        for i in range(0, stop, batch_size):
            yield gather(order[i : i + batch_size])


class SliceDataset:
    """In-memory pool of preprocessed slices with shuffled batch iteration;
    the pairs are preprocessed on ``device``."""

    def __init__(self, pairs: Sequence[Pair], resolution=(256, 256), device=None):
        images, labels = [], []
        for vol, mask in pairs:
            im, lb = slices_from_pair(np.asarray(vol), np.asarray(mask), resolution, device)
            images.append(im)
            labels.append(lb)
        self.images = np.concatenate(images, axis=0)
        self.labels = np.concatenate(labels, axis=0)

    def __len__(self) -> int:
        return self.images.shape[0]

    def batches(
        self, batch_size: int, *, seed: int = 0, epochs: int = 1, drop_last: bool = True
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (images (B,256,256,1) f32, labels (B,256,256) i32)."""
        return iter_shuffled_batches(
            len(self),
            batch_size,
            lambda idx: (self.images[idx][..., None], self.labels[idx]),
            seed=seed,
            epochs=epochs,
            drop_last=drop_last,
            what="dataset",
        )
