"""The fine-tuning step, plain: the slices and labels of each volume
(lungmask's preprocessing, the labels zoomed by nearest neighbour into the
same boxes), the shuffled batches and the augmentation as the port's
documented recipe draws them (numpy ``default_rng(seed)``: a permutation
per epoch; flips with the lung labels swapped, shift/scale, intensity
jitter, noise), the float32 U-Net of :mod:`.unet`, the loss
(1 − w)·NLL + w·soft Dice, autograd, and optax's
``chain(clip_by_global_norm(1), adamw(warmup_cosine_decay_schedule))``
with the fine-tuning defaults (peak 1e-4 from 1e-6 over the first tenth of
the steps, weight decay 1e-5).

:func:`first_steps` follows the first three steps and returns each step's
loss, each leaf's norm of the first (clipped) gradient, and each leaf's
norm of the change after the three steps; :func:`gaps` compares them with
the program's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy import ndimage

from portbench.reference import pipeline, unet


def slices_and_labels(volume: np.ndarray, labels: np.ndarray, size: int = 256):
    images, boxes = pipeline.preprocess(volume, size)
    out = np.empty((len(boxes), size, size), np.int32)
    for i, (lab, b) in enumerate(zip(labels, boxes)):
        crop = lab[b[0]:b[2], b[1]:b[3]].astype(np.int32)
        out[i] = ndimage.zoom(crop, np.asarray([size, size]) / np.asarray(crop.shape), order=0)
    return images.astype(np.float32), out


def augment(images: np.ndarray, labels: np.ndarray, rng: np.random.Generator,
            lr_swap) -> tuple:
    """Flip p 0.5 (lung labels swapped on flipped slices), shift ±16 px and
    zoom 0.9–1.1 p 0.5 (nearest, border clamped), intensity ×(1 ± 0.05) +
    ±0.05 p 0.5, Gaussian noise σ 0.01 p 0.25; images re-clipped to [0, 1]."""
    b, h, w = images.shape
    do = rng.random(b) < 0.5
    images = np.where(do[:, None, None], images[:, :, ::-1], images)
    flipped = np.where(do[:, None, None], labels[:, :, ::-1], labels)
    if lr_swap is not None:
        a, c = lr_swap
        swapped = flipped.copy()
        swapped[flipped == a] = c
        swapped[flipped == c] = a
        flipped = np.where(do[:, None, None], swapped, flipped)
    labels = flipped
    out_i, out_l = images.copy(), labels.copy()
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    for i in range(b):
        if rng.random() >= 0.5:
            continue
        s = rng.uniform(0.9, 1.1)
        dy = int(rng.integers(-16, 17))
        dx = int(rng.integers(-16, 17))
        sy = np.clip(np.rint((yy - cy) / s + cy - dy), 0, h - 1).astype(int)
        sx = np.clip(np.rint((xx - cx) / s + cx - dx), 0, w - 1).astype(int)
        out_i[i] = images[i][sy, sx]
        out_l[i] = labels[i][sy, sx]
    images, labels = out_i, out_l
    do = rng.random(b) < 0.5
    scale = np.where(do, 1.0 + rng.uniform(-0.05, 0.05, b), 1.0)
    shift = np.where(do, rng.uniform(-0.05, 0.05, b), 0.0)
    images = np.clip(images * scale[:, None, None] + shift[:, None, None], 0.0, 1.0).astype(
        np.float32)
    do = (rng.random(b) < 0.25)[:, None, None]
    noise = rng.normal(0.0, 0.01, images.shape)
    images = np.clip(images + np.where(do, noise, 0.0), 0.0, 1.0).astype(np.float32)
    return images, labels


def loss_fn(logits: torch.Tensor, labels: torch.Tensor, dice_weight: float) -> torch.Tensor:
    """logits (N, K, H, W), labels (N, H, W)."""
    logp = torch.log_softmax(logits, 1)
    nll = -torch.gather(logp, 1, labels.unsqueeze(1)).mean()
    probs = torch.softmax(logits, 1)
    onehot = torch.nn.functional.one_hot(labels, logits.shape[1]).permute(0, 3, 1, 2).float()
    inter = (probs * onehot).sum((0, 2, 3))
    denom = (probs + onehot).sum((0, 2, 3))
    dice = 1.0 - torch.mean((2 * inter + 1e-6) / (denom + 1e-6))
    return (1.0 - dice_weight) * nll + dice_weight * dice


def learning_rate(count: int, n_batches: int, peak: float = 1e-4) -> float:
    warmup = max(1, int(n_batches * 0.1))
    init = peak * 1e-2
    if count < warmup:
        return init + (peak - init) * count / warmup
    span = max(n_batches, warmup + 1) - warmup
    t = min(count - warmup, span)
    return peak * 0.5 * (1 + math.cos(math.pi * t / span))


def first_steps(pairs, flat: Dict[str, np.ndarray], *, batch: int, seed: int, n_batches: int,
                dice_weight: float, lr_swap, size: int, device, steps: int = 3,
                quant: unet.Quant = None, keep: Optional[int] = None) -> dict:
    """The reference's first ``steps`` steps. ``quant`` computes the
    forward in a lower precision (the control); ``keep`` takes the loss
    over the first ``keep`` slices of each batch only (a planted fault)."""
    data = [slices_and_labels(v, lab, size) for v, lab in pairs]
    images = np.concatenate([d[0] for d in data])
    labels = np.concatenate([d[1] for d in data])
    order = np.random.default_rng(seed).permutation(len(images))
    rng = np.random.default_rng(seed)
    p = unet.tensors(flat, device, requires_grad=True)
    p0 = {k: v.detach().clone() for k, v in p.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    for step in range(steps):
        idx = order[step * batch:(step + 1) * batch]
        x, y = augment(images[idx], labels[idx], rng, lr_swap)
        n = keep or batch
        xt = torch.as_tensor(x[:n], device=device)
        yt = torch.as_tensor(y[:n].astype(np.int64), device=device)
        loss = loss_fn(unet.logits(p, xt, quant), yt, dice_weight)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = dict(zip(p, grads))
            norm = float(torch.sqrt(sum((t * t).sum() for t in g.values())))
            if norm >= 1.0:
                g = {k: t / norm for k, t in g.items()}
            if step == 0:
                grad1 = {k: float(t.norm()) for k, t in g.items()}
            count = step + 1
            c1, c2 = 1 - 0.9 ** count, 1 - 0.999 ** count
            lr = learning_rate(step, n_batches)
            for k, t in g.items():
                mu[k] = 0.1 * t + 0.9 * mu[k]
                nu[k] = 0.001 * t * t + 0.999 * nu[k]
                u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8)
                p[k] -= lr * (u + 1e-5 * p[k])
    change = {k: float((p[k].detach() - p0[k]).norm()) for k in p}
    return {"loss": losses, "grad": grad1, "change": change}


def gaps(prog: dict, ref: dict) -> dict:
    """``loss_gap``: the largest relative gap of a step's loss.
    ``grad_gap`` / ``change_gap``: the worst leaf's gap between the
    program's norm and the reference's, over the larger of that leaf's
    reference norm and the median leaf's. Leaves whose reference gradient
    is under a thousandth of the median leaf's move by round-off alone and
    are left out of ``change_gap`` (``left_out`` counts them)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    med_g = float(np.median(list(ref["grad"].values())))
    grad = max(abs(prog["grad"][k] - r) / max(r, med_g) for k, r in ref["grad"].items())
    moving = [k for k, r in ref["grad"].items() if r >= 1e-3 * med_g]
    med_c = float(np.median([ref["change"][k] for k in moving]))
    change = max(abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], med_c)
                 for k in moving)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "left_out": len(ref["grad"]) - len(moving)}
