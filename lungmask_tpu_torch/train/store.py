"""Disk-backed preprocessed slice store for large fine-tuning datasets (a
copy of ``lungmask_tpu.train.store`` on the port's ``train.data``).

``SliceDataset`` holds every preprocessed slice in RAM — fine for a handful
of volumes, not for cohort-scale fine-tuning (a 300-slice volume is ~75 MB
of float32 256² slices; 100 volumes don't fit a host). ``SliceStore`` runs
the same inference-identical preprocessing ONCE, appends the results to flat
binary files, and serves shuffled batches through ``np.memmap`` so the
training loop touches only the pages a batch needs. Images are stored
float16 (the normalized intensities live in [0, 1]; fp16 round-off is ~6e-4,
far below the bf16 compute noise of the train step) and yielded float32.

The batch API mirrors ``SliceDataset.batches`` so ``fit()`` accepts either
interchangeably. A capability extension — the reference ships no training
code at all (SURVEY §2.2).
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, Sequence, Tuple

import numpy as np

from lungmask_tpu_torch.logger import logger
from lungmask_tpu_torch.train.data import Pair, iter_shuffled_batches, slices_from_pair

_META = "store.json"
_IMAGES = "images.f16"
_LABELS = "labels.i16"


def build_store(
    out_dir: str,
    pairs: Iterable[Pair],
    resolution: Tuple[int, int] = (256, 256),
    device=None,
) -> "SliceStore":
    """Preprocess ``pairs`` of (HU volume, label mask) into ``out_dir``, on
    ``device`` (``slices_from_pair``).

    ``pairs`` may be any iterable (a generator keeps peak memory at one
    volume). Appends are flat-file, so a partial build can be resumed by
    rebuilding from scratch — the store is a cache, not a database.
    """
    os.makedirs(out_dir, exist_ok=True)
    h, w = int(resolution[0]), int(resolution[1])
    n = 0
    with open(os.path.join(out_dir, _IMAGES), "wb") as fi, open(
        os.path.join(out_dir, _LABELS), "wb"
    ) as fl:
        for vol, mask in pairs:
            images, labels = slices_from_pair(
                np.asarray(vol), np.asarray(mask), resolution, device=device
            )
            fi.write(np.ascontiguousarray(images, np.float16).tobytes())
            fl.write(np.ascontiguousarray(labels, np.int16).tobytes())
            n += images.shape[0]
    if n == 0:
        # np.memmap cannot map an empty file — a 0-slice store would crash
        # cryptically at load; fail here and don't leave broken files behind.
        os.remove(os.path.join(out_dir, _IMAGES))
        os.remove(os.path.join(out_dir, _LABELS))
        raise ValueError(
            f"build_store: no slices produced (empty `pairs`?); {out_dir} "
            "left without a store"
        )
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump({"n": n, "h": h, "w": w, "version": 1}, f)
    logger.info(f"SliceStore: wrote {n} slices ({h}x{w}) to {out_dir}")
    return SliceStore(out_dir)


def build_store_from_files(
    out_dir: str,
    file_pairs: Sequence[Tuple[str, str]],
    resolution: Tuple[int, int] = (256, 256),
    device=None,
) -> "SliceStore":
    """Build from (volume_path, mask_path) pairs, decoding one volume at a
    time (any format ``io.loader`` reads)."""
    from lungmask_tpu_torch.io import load_input_image

    def gen():
        for vol_path, mask_path in file_pairs:
            yield (
                load_input_image(vol_path).array,
                load_input_image(mask_path).array,
            )

    return build_store(out_dir, gen(), resolution, device)


class SliceStore:
    """Memmap-backed slice pool with the ``SliceDataset`` batch API."""

    def __init__(self, store_dir: str):
        meta_path = os.path.join(store_dir, _META)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{store_dir}: not a slice store (missing {_META}); "
                "build one with train.store.build_store(...)"
            )
        with open(meta_path) as f:
            meta = json.load(f)
        self.dir = store_dir
        n, h, w = meta["n"], meta["h"], meta["w"]
        self.images = np.memmap(
            os.path.join(store_dir, _IMAGES), np.float16, "r", shape=(n, h, w)
        )
        self.labels = np.memmap(
            os.path.join(store_dir, _LABELS), np.int16, "r", shape=(n, h, w)
        )

    def __len__(self) -> int:
        return self.images.shape[0]

    def batches(
        self, batch_size: int, *, seed: int = 0, epochs: int = 1, drop_last: bool = True
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (images (B,H,W,1) f32, labels (B,H,W) i32), shuffled.

        Batch gathers sort the shuffled indices before touching the memmap
        (sequential page reads) and restore the shuffled order after.
        """
        def gather(idx):
            take = np.sort(idx)
            undo = np.argsort(np.argsort(idx))
            images = np.asarray(self.images[take], np.float32)[undo]
            labels = np.asarray(self.labels[take], np.int32)[undo]
            return images[..., None], labels

        return iter_shuffled_batches(
            len(self),
            batch_size,
            gather,
            seed=seed,
            epochs=epochs,
            drop_last=drop_last,
            what="store",
        )
