"""Data augmentation for fine-tuning: paired image/label transforms (a copy
of ``lungmask_tpu.train.augment``, numpy only).

A capability extension (the reference ships no training code, SURVEY §2.2).
The augmentations mirror the families described for the original R231
training recipe (Hofmanninger et al., Eur Radiol Exp 4:50 (2020), the paper
the reference lungmask's README cites — rotation, shift/scale, noise),
applied host-side on preprocessed 256² slice batches.

Geometric transforms apply identically to image and label (order-0 for the
label, order-1 for the image); intensity transforms touch the image only.
Every op takes an explicit ``np.random.Generator`` — a seeded pipeline is
exactly reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]  # images (B,H,W) f32, labels (B,H,W) i32


def flip(images: np.ndarray, labels: np.ndarray, rng: np.random.Generator,
         p: float = 0.5) -> Batch:
    """Random left-right flip per slice (anatomy is laterally ~symmetric;
    note this swaps left/right lung labels only for models whose classes are
    lateralized — see ``swap_labels``)."""
    do = rng.random(images.shape[0]) < p
    images = np.where(do[:, None, None], images[:, :, ::-1], images)
    labels = np.where(do[:, None, None], labels[:, :, ::-1], labels)
    return images, labels


def swap_labels(labels: np.ndarray, a: int, b: int,
                mask: np.ndarray | None = None) -> np.ndarray:
    """Exchange two label values (e.g. right/left lung after an LR flip).
    ``mask`` restricts the swap to flipped slices (bool per slice)."""
    swapped = labels.copy()
    swapped[labels == a] = b
    swapped[labels == b] = a
    if mask is None:
        return swapped
    return np.where(mask[:, None, None], swapped, labels)


def rotate90(images: np.ndarray, labels: np.ndarray,
             rng: np.random.Generator, p: float = 0.25) -> Batch:
    """Random 90/180/270° rotation per slice (exact, no resampling)."""
    out_i, out_l = images.copy(), labels.copy()
    for i in range(images.shape[0]):
        if rng.random() < p:
            k = int(rng.integers(1, 4))
            out_i[i] = np.rot90(images[i], k)
            out_l[i] = np.rot90(labels[i], k)
    return out_i, out_l


def shift_scale(images: np.ndarray, labels: np.ndarray,
                rng: np.random.Generator, max_shift: int = 16,
                scale_range: Tuple[float, float] = (0.9, 1.1),
                p: float = 0.5) -> Batch:
    """Random integer translation + nearest-resampled zoom about the center.

    Implemented as an index-remap gather (one coordinate grid per slice):
    order-0 for both channels keeps labels crisp; the image is float so
    order-0 only costs sub-pixel smoothness, irrelevant at ±10% jitter.
    Out-of-range samples clamp to the border (replicate padding).
    """
    b, h, w = images.shape
    out_i, out_l = images.copy(), labels.copy()
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    for i in range(b):
        if rng.random() >= p:
            continue
        s = rng.uniform(*scale_range)
        dy = int(rng.integers(-max_shift, max_shift + 1))
        dx = int(rng.integers(-max_shift, max_shift + 1))
        src_y = np.clip(np.rint((yy - cy) / s + cy - dy), 0, h - 1).astype(int)
        src_x = np.clip(np.rint((xx - cx) / s + cx - dx), 0, w - 1).astype(int)
        out_i[i] = images[i][src_y, src_x]
        out_l[i] = labels[i][src_y, src_x]
    return out_i, out_l


def intensity_jitter(images: np.ndarray, rng: np.random.Generator,
                     shift: float = 0.05, scale: float = 0.05,
                     p: float = 0.5) -> np.ndarray:
    """Per-slice affine intensity jitter in normalized units (the engine
    feeds (HU+1024)/1624 ∈ [0,1]); output re-clipped to [0,1]."""
    b = images.shape[0]
    do = rng.random(b) < p
    a = np.where(do, 1.0 + rng.uniform(-scale, scale, b), 1.0)
    off = np.where(do, rng.uniform(-shift, shift, b), 0.0)
    out = images * a[:, None, None] + off[:, None, None]
    return np.clip(out, 0.0, 1.0).astype(images.dtype)


def gaussian_noise(images: np.ndarray, rng: np.random.Generator,
                   sigma: float = 0.01, p: float = 0.5) -> np.ndarray:
    """Additive Gaussian noise in normalized units, re-clipped to [0,1]."""
    b = images.shape[0]
    do = (rng.random(b) < p)[:, None, None]
    noise = rng.normal(0.0, sigma, images.shape)
    return np.clip(images + np.where(do, noise, 0.0), 0.0, 1.0).astype(
        images.dtype
    )


@dataclass
class Augmenter:
    """Composed augmentation policy over (images, labels) batches.

    Defaults are conservative; set any probability to 0 to disable a family.
    ``lr_swap`` optionally names a (right, left) label pair to exchange on
    flipped slices (R231's classes are lateralized: 1=right, 2=left lung).
    """

    flip_p: float = 0.5
    rot90_p: float = 0.0  # axial CT rarely benefits; off by default
    shift_scale_p: float = 0.5
    max_shift: int = 16
    scale_range: Tuple[float, float] = (0.9, 1.1)
    intensity_p: float = 0.5
    noise_p: float = 0.25
    noise_sigma: float = 0.01
    lr_swap: Tuple[int, int] | None = None

    def __call__(self, images: np.ndarray, labels: np.ndarray,
                 rng: np.random.Generator) -> Batch:
        if self.flip_p > 0:
            do = rng.random(images.shape[0]) < self.flip_p
            images = np.where(do[:, None, None], images[:, :, ::-1], images)
            flipped = np.where(do[:, None, None], labels[:, :, ::-1], labels)
            if self.lr_swap is not None:
                flipped = swap_labels(flipped, *self.lr_swap, mask=do)
            labels = flipped
        if self.rot90_p > 0:
            images, labels = rotate90(images, labels, rng, self.rot90_p)
        if self.shift_scale_p > 0:
            images, labels = shift_scale(
                images, labels, rng, self.max_shift, self.scale_range,
                self.shift_scale_p,
            )
        if self.intensity_p > 0:
            images = intensity_jitter(images, rng, p=self.intensity_p)
        if self.noise_p > 0:
            images = gaussian_noise(images, rng, self.noise_sigma, self.noise_p)
        return images, labels
