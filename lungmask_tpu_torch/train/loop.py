"""The fine-tuning loop: ``fit`` = schedule + augment + step + eval +
checkpoint (counterpart of ``lungmask_tpu.train.loop``).

Composes ``SliceDataset`` batches, ``Augmenter``, ``make_train_step`` and
``checkpoint`` into one reproducible loop with periodic Dice evaluation and
best-state tracking. The shuffle and the augmentation draw from numpy's
``default_rng(seed)`` exactly as the JAX package's loop does, so both
packages see the same batches. Runs on the GPU unless ``device="cpu"`` is
asked for.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from lungmask_tpu_torch import metrics
from lungmask_tpu_torch.logger import logger
from lungmask_tpu_torch.models import unet
from lungmask_tpu_torch.train.augment import Augmenter
from lungmask_tpu_torch.train.checkpoint import save_train_state
from lungmask_tpu_torch.train.data import SliceDataset
from lungmask_tpu_torch.train.optim import AdamW, default_optimizer
from lungmask_tpu_torch.train.trainer import TrainState, init_train_state, make_train_step
from lungmask_tpu_torch.utils.device import resolve_device


@dataclass
class FitResult:
    state: TrainState          # final train state
    best_params: Any           # port tree at the best eval macro-Dice (or final)
    best_dice: float
    history: List[Dict[str, float]] = field(default_factory=list)


def evaluate(params, images: np.ndarray, labels: np.ndarray,
             batch_size: int = 8, compute_dtype=torch.bfloat16) -> float:
    """Macro Dice of argmax predictions over an eval slice pool, on the
    device of ``params`` (a port tree).

    images (N,H,W) float32 normalized, labels (N,H,W) int. Runs in
    ``batch_size`` chunks under ``inference_mode``; the last chunk is
    simply shorter.
    """
    model = unet.UNet(params, compute_dtype)
    device = next(iter(model.buffers())).device
    preds = []
    with torch.inference_mode():
        for i in range(0, images.shape[0], batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(images[i : i + batch_size]))
            preds.append(unet.unet_argmax(model, chunk.to(device).unsqueeze(-1)).cpu())
    pred = torch.cat(preds).numpy()
    return float(metrics.compare_masks(pred, labels.astype(np.uint8)).macro_dice)


def _snapshot(params):
    """A detached copy of a port tree."""
    if isinstance(params, dict):
        return {k: _snapshot(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_snapshot(v) for v in params]
    return params.detach().clone()


def fit(
    params,
    dataset: SliceDataset,
    *,
    epochs: int = 1,
    batch_size: int = 8,
    optimizer: Optional[AdamW] = None,
    mesh=None,
    augment: Optional[Augmenter] = None,
    eval_pairs: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    eval_every: int = 0,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    seed: int = 0,
    log_every: int = 10,
    compute_dtype=torch.bfloat16,
    dice_weight: float = 0.5,
    remat: bool = False,
    device=None,
) -> FitResult:
    """Fine-tune ``params`` (a port tree, ``models/convert.from_jax_params``)
    on ``dataset``, on ``device`` (CUDA unless ``"cpu"``), or with ``mesh``
    on the mesh's devices.

    * ``eval_pairs`` — (images (N,H,W), labels (N,H,W)) held-out slices;
      evaluated every ``eval_every`` steps (and at the end) with macro Dice;
      the best-scoring params are kept in ``FitResult.best_params``.
    * ``checkpoint_path`` + ``checkpoint_every`` — periodic exact-resume
      snapshots via ``train.checkpoint`` (also written at the end).
    * ``mesh`` — a ``parallel.Mesh``: each batch splits over its data axis
      (``batch_size`` must divide over it) and each part's slice height over
      its space axis, the weights and the optimizer's state live on its
      first data device, evaluation runs there (``make_train_step(mesh=)``).
    """
    if mesh is not None:
        ndata = mesh.shape["data"]
        if batch_size % ndata:
            raise ValueError(
                f"batch_size={batch_size} does not split evenly over the mesh's "
                f"{ndata}-way data axis"
            )
        device = mesh.data_devices[0]
    else:
        device = resolve_device(device)
    n_batches = (len(dataset) // batch_size) * epochs
    if n_batches == 0:
        raise ValueError(
            f"dataset ({len(dataset)} slices) yields no batches at "
            f"batch_size={batch_size}"
        )
    if optimizer is None:
        optimizer = default_optimizer(n_batches)
    step_fn = make_train_step(
        optimizer, mesh=mesh, compute_dtype=compute_dtype, dice_weight=dice_weight, remat=remat,
    )
    state = init_train_state(params, optimizer, device)
    rng = np.random.default_rng(seed)
    history: List[Dict[str, float]] = []
    best_dice, best_params = float("-inf"), None

    def run_eval(step_no: int):
        nonlocal best_dice, best_params
        imgs, lbls = eval_pairs
        d = evaluate(state.params, np.asarray(imgs), np.asarray(lbls),
                     batch_size=batch_size, compute_dtype=compute_dtype)
        history.append({"step": float(step_no), "eval_macro_dice": d})
        logger.info(f"fit step {step_no}: eval macro Dice {d:.4f}")
        if d > best_dice:
            best_dice, best_params = d, _snapshot(state.params)

    step_no = 0
    for images, labels in dataset.batches(
        batch_size, seed=seed, epochs=epochs, drop_last=True
    ):
        if augment is not None:
            aug_i, aug_l = augment(images[..., 0], labels, rng)
            images, labels = aug_i[..., None], aug_l
        state, loss = step_fn(state, images, labels)
        step_no += 1
        if log_every and step_no % log_every == 0:
            history.append({"step": float(step_no), "loss": float(loss)})
            logger.info(f"fit step {step_no}/{n_batches}: loss {float(loss):.4f}")
        if eval_pairs is not None and eval_every and step_no % eval_every == 0:
            run_eval(step_no)
        if checkpoint_path and checkpoint_every and step_no % checkpoint_every == 0:
            save_train_state(checkpoint_path, state)

    # final eval/checkpoint, unless the last step already triggered them
    if eval_pairs is not None and not (eval_every and step_no % eval_every == 0):
        run_eval(step_no)
    if checkpoint_path and not (
        checkpoint_every and step_no % checkpoint_every == 0
    ):
        save_train_state(checkpoint_path, state)
    if best_params is None:
        best_dice, best_params = float("nan"), _snapshot(state.params)
    return FitResult(
        state=state, best_params=best_params, best_dice=best_dice,
        history=history,
    )
