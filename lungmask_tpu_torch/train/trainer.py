"""Fine-tuning support: losses, the train state and the train step
(counterpart of ``lungmask_tpu.train.trainer``).

* NLL loss against the model's log-softmax head plus soft Dice, weighted as
  in the JAX package.
* :func:`make_train_step` returns ``step(state, images, labels) → (state,
  loss)``: forward through the U-Net (its pooling and upsampling K2 and K3
  on the GPU), ``loss.backward()`` (K2ᵀ and K3ᵀ), then the optimizer's
  update. The step runs outside ``inference_mode``; at float32 cuDNN's
  TF32 stays off for the backward too. Unlike JAX's pure step, the state's
  model is updated in place and the returned state shares it.
* ``remat`` recomputes the forward in the backward
  (``torch.utils.checkpoint``, non-reentrant), trading compute for
  activation memory.
* ``mesh=`` (the sharded step) is ROADMAP.md queue 1, item 10.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from lungmask_tpu_torch.models import unet
from lungmask_tpu_torch.train.optim import AdamW, OptState, apply_updates

Params = unet.Params


@dataclass
class TrainState:
    """The trainable U-Net (float32 master weights as parameters), the
    optimizer's state and the number of steps taken."""

    model: unet.UNet
    opt_state: OptState
    step: int

    @property
    def params(self) -> Params:
        """The live weights as a port tree (``models/convert``)."""
        return self.model.tree()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean per-pixel NLL. logits (N,H,W,C) float32, labels (N,H,W) int."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, labels.unsqueeze(-1).long())
    return -picked.mean()


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mean soft-Dice loss over classes (one-hot vs softmax probabilities)."""
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(probs.dtype)
    inter = torch.sum(probs * onehot, dim=(0, 1, 2))
    denom = torch.sum(probs + onehot, dim=(0, 1, 2))
    dice = (2 * inter + eps) / (denom + eps)
    return 1.0 - torch.mean(dice)


def init_train_state(params: Params, optimizer: AdamW, device=None) -> TrainState:
    """A trainable U-Net on ``device`` (``params``' by default) from a port
    tree, with the optimizer's initial state."""
    model = unet.UNet(params, torch.float32, trainable=True)
    if device is not None:
        model = model.to(device)
    return TrainState(model, optimizer.init(dict(model.named_parameters())), 0)


def make_train_step(
    optimizer: AdamW,
    mesh=None,
    compute_dtype: torch.dtype = torch.bfloat16,
    dice_weight: float = 0.5,
    remat: bool = False,
):
    """``step(state, images (N,H,W,1), labels (N,H,W)) → (state, loss)``;
    images and labels may be numpy arrays or tensors (moved to the model's
    device); the loss is a 0-d float32 tensor on it."""
    if mesh is not None:
        raise NotImplementedError(
            "the mesh-sharded train step is not ported to lungmask_tpu_torch yet "
            "(ROADMAP.md queue 1, item 10)"
        )

    def loss_fn(model: unet.UNet, images, labels):
        if remat:
            logits = checkpoint(model.logits, images, compute_dtype, use_reentrant=False)
        else:
            logits = model.logits(images, compute_dtype)
        ce = cross_entropy_loss(logits, labels)
        dc = dice_loss(logits, labels)
        return (1.0 - dice_weight) * ce + dice_weight * dc

    def step(state: TrainState, images, labels) -> Tuple[TrainState, torch.Tensor]:
        model = state.model
        params = dict(model.named_parameters())
        device = next(iter(params.values())).device
        images, labels = torch.as_tensor(images).to(device), torch.as_tensor(labels).to(device)
        with torch.inference_mode(False), torch.enable_grad(), unet.conv_flags(compute_dtype):
            model.zero_grad(set_to_none=True)
            loss = loss_fn(model, images, labels)
            loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state, params)
            apply_updates(params, updates)
        return TrainState(model, opt_state, state.step + 1), loss.detach()

    return step
