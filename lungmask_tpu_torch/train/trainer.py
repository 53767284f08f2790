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
* ``mesh=`` (the sharded step, :func:`_sharded_step`): the batch splits
  over the mesh's data axis, one replica of the weights per part on its
  device, and with ``space > 1`` each part's images and labels split by
  height into bands over its row's space devices (JAX's ``P("data",
  "space")``), run in lockstep with halo rows (``parallel/halo.py``); the
  blocks' loss sums meet on the first device, the gradient of each replica
  is summed into the state's model in mesh order, and one optimizer update
  runs there. In a group of several processes (``parallel.multihost``),
  the loss sums and the gradients are also summed over the group; the
  space axis spans only each process's own devices.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.distributed as dist
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


def _dice_sums(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per class, the sums over the batch of probability × one-hot and of
    probability + one-hot."""
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(probs.dtype)
    return torch.sum(probs * onehot, dim=(0, 1, 2)), torch.sum(probs + onehot, dim=(0, 1, 2))


def _dice_from_sums(inter: torch.Tensor, denom: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return 1.0 - torch.mean((2 * inter + eps) / (denom + eps))


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mean soft-Dice loss over classes (one-hot vs softmax probabilities),
    its sums taken over the whole batch."""
    return _dice_from_sums(*_dice_sums(logits, labels), eps)


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
    device); the loss is a 0-d float32 tensor on it. With ``mesh``, N
    divides over its data axis and the state's model lies on its first data
    device (:func:`_sharded_step`)."""
    if mesh is not None:
        return _sharded_step(optimizer, mesh, compute_dtype, dice_weight, remat)

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


def _replicas(master: unet.UNet, devices) -> List[unet.UNet]:
    """``master`` and one copy of it on each further device (a device named
    again gets a copy of its own, so every part's gradient is its own)."""
    return [master] + [copy.deepcopy(master).to(dev) for dev in devices[1:]]


def _sharded_step(optimizer: AdamW, mesh, compute_dtype: torch.dtype, dice_weight: float,
                  remat: bool):
    """The train step over the data and space axes of ``mesh`` (module
    docstring).

    The loss is the unsharded step's: its cross-entropy the summed NLL over
    the pixel count of the whole batch, its Dice from the per-class sums
    over the whole batch — never an average of the parts' losses, which
    weighs each part's Dice alike and is another function. Each block
    (a data row's band) gives its sums. Autograd carries the gradient back
    through the copies of the blocks' sums to the first device, through the
    halo copies to the bands that own those rows, and through each band's
    copy of its row's weights to that row's replica. In a process group
    (``torch.distributed`` initialised), the sums meet by a differentiable
    all-reduce — every process passes a batch of the same size — whose
    backward sums the loss's gradient over the group once more, so each
    replica's gradient is divided by the group's size once before the
    gradients are summed over the group. ``remat`` checkpoints a data row's
    forward as a whole: a band's forward needs its neighbours'."""
    from lungmask_tpu_torch.parallel.halo import Bands
    from lungmask_tpu_torch.parallel.mesh import shard_bands, shard_batch

    devices = mesh.data_devices
    space = mesh.shape["space"]
    held = {"master": None, "replicas": []}

    def row_logits(model, *bands):
        """A data row's logits: a list of its bands' (one band: the
        unbanded forward)."""
        if len(bands) == 1:
            return [model.logits(bands[0], compute_dtype)]
        return model.logits(Bands(bands), compute_dtype).parts

    def logits_of(model, bands):
        if remat:
            return checkpoint(row_logits, model, *bands, use_reentrant=False)
        return row_logits(model, *bands)

    def step(state: TrainState, images, labels) -> Tuple[TrainState, torch.Tensor]:
        master = state.model
        params = dict(master.named_parameters())
        first = next(iter(params.values())).device
        if first != devices[0]:
            raise ValueError(f"the state's model lies on {first}, the mesh starts at {devices[0]}")
        if held["master"] is not master:
            held["master"], held["replicas"] = master, _replicas(master, devices)
        models = held["replicas"]
        images, labels = torch.as_tensor(images), torch.as_tensor(labels)
        xs, ys = shard_batch(mesh, images), shard_batch(mesh, labels)
        if space > 1:  # labels' bands without rows have no logits
            depth = len(master.down)
            xs = [shard_bands(mesh, d, x, depth) for d, x in enumerate(xs)]
            ys = [[y for y in shard_bands(mesh, d, y, depth) if y.shape[1]]
                  for d, y in enumerate(ys)]
        else:
            xs, ys = [[x] for x in xs], [[y] for y in ys]
        grouped = dist.is_available() and dist.is_initialized()
        with torch.inference_mode(False), torch.enable_grad(), unet.conv_flags(compute_dtype):
            with torch.no_grad():
                for m in models[1:]:
                    for p, q in zip(m.parameters(), master.parameters()):
                        p.copy_(q)
            for m in models:
                m.zero_grad(set_to_none=True)
            sums = None
            for m, x, y in zip(models, xs, ys):
                for logits, lab in zip(logits_of(m, x), y):
                    nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1,
                                        lab.unsqueeze(-1).long()).sum()
                    part = torch.cat([nll.view(1), *_dice_sums(logits, lab)]).to(first)
                    sums = part if sums is None else sums + part
            count = labels.numel()
            if grouped:
                from torch.distributed.nn.functional import all_reduce

                sums = all_reduce(sums)
                count *= dist.get_world_size()
            c = (sums.shape[0] - 1) // 2
            ce = sums[0] / count
            loss = (1.0 - dice_weight) * ce + dice_weight * _dice_from_sums(sums[1 : 1 + c],
                                                                            sums[1 + c :])
            loss.backward()
        with torch.no_grad():
            grads = {k: p.grad.clone() for k, p in params.items()}
            for m in models[1:]:
                for k, p in m.named_parameters():
                    grads[k] += p.grad.to(first)
            if grouped:
                keys = list(grads)
                flat = torch.cat([grads[k].reshape(-1) for k in keys]) / dist.get_world_size()
                dist.all_reduce(flat)
                for k, g in zip(keys, torch.split(flat, [grads[k].numel() for k in keys])):
                    grads[k] = g.view_as(grads[k])
            updates, opt_state = optimizer.update(grads, state.opt_state, params)
            apply_updates(params, updates)
        return TrainState(master, opt_state, state.step + 1), loss.detach()

    return step
