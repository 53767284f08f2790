"""The fine-tuning optimizer: AdamW under a linear-warmup + cosine-decay
schedule, the gradient clipped by its global norm first — in place of
optax, which the GPU machine lacks (counterpart of
``lungmask_tpu.train.loop.default_optimizer``'s ``optax.chain(
clip_by_global_norm(1.0), adamw(warmup_cosine_decay_schedule(...)))``).

Functional like optax: :meth:`AdamW.init` makes the state,
:meth:`AdamW.update` maps gradients to updates and a new state, and
:func:`apply_updates` adds the updates to the parameters (in place). Trees
are flat dicts of float32 tensors keyed by parameter name. The arithmetic
is optax's, per element in float32:

* clip: ``g / ‖g‖ · max_norm`` when ``‖g‖ ≥ max_norm`` (not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm);
* Adam: ``mu = (1 − b1)·g + b1·mu``, ``nu = (1 − b2)·g² + b2·nu``, the
  count incremented, ``u = mu_hat / (sqrt(nu_hat) + eps)`` with the bias
  corrections of the new count, eps outside the square root;
* decoupled weight decay on every leaf: ``u + wd·p``;
* the step: ``−lr(k)·u`` with the schedule at the count ``k`` *before*
  this update.

The scalars (the schedule's value, the bias corrections) are computed in
float32, as optax computes them: in float64, ``1 − 0.999`` alone differs
from float32's by 1.3e-5 relative.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]
_f32 = np.float32


@dataclass
class OptState:
    """optax's state of the chain, leaf for leaf: Adam's ``count``, ``mu``
    and ``nu``, and the schedule's own ``schedule_count``."""

    count: int
    mu: Tree
    nu: Tree
    schedule_count: int


def init_state(params: Tree) -> OptState:
    """Zero moments shaped like ``params``, counts 0."""
    zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    return OptState(count=0, mu=zeros, nu={k: v.clone() for k, v in zeros.items()},
                    schedule_count=0)


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
) -> Callable[[int], float]:
    """optax's schedule (with its default end value 0): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    from ``peak_value`` to 0 over the remaining ``decay_steps −
    warmup_steps``; optax's float32 arithmetic, step by step."""
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = _f32(1) - _f32(min(max(count, 0), warmup_steps)) / _f32(warmup_steps)
            return float(_f32(init_value - peak_value) * frac + _f32(peak_value))
        t = _f32(min(count - warmup_steps, span))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * t / _f32(span)))
        return float(_f32(peak_value) * cosine)

    return schedule


B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults
MAX_NORM = 1.0  # default_optimizer's clip


@dataclass(frozen=True)
class AdamW:
    """optax's ``chain(clip_by_global_norm(1.0), adamw(learning_rate,
    weight_decay=weight_decay))``, the chain ``default_optimizer`` builds."""

    learning_rate: Callable[[int], float]
    weight_decay: float

    def init(self, params: Tree) -> OptState:
        return init_state(params)

    def update(self, grads: Tree, state: OptState, params: Tree) -> Tuple[Tree, OptState]:
        """Updates for ``grads`` at ``params`` and the next state; nothing
        is modified in place."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < MAX_NORM
        grads = {k: torch.where(keep, g, (g / norm) * MAX_NORM) for k, g in grads.items()}
        count = state.count + 1
        c1 = float(_f32(1) - _f32(B1) ** _f32(count))
        c2 = float(_f32(1) - _f32(B2) ** _f32(count))
        step = -self.learning_rate(state.schedule_count)
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1.0 - B1) * g + B1 * state.mu[k]
            nu[k] = (1.0 - B2) * (g * g) + B2 * state.nu[k]
            u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS)
            updates[k] = step * (u + self.weight_decay * params[k])
        return updates, OptState(count=count, mu=mu, nu=nu,
                                 schedule_count=state.schedule_count + 1)


def apply_updates(params: Tree, updates: Tree) -> None:
    """``p ← p + u`` for each parameter, in place and outside autograd."""
    with torch.no_grad():
        for k, p in params.items():
            p.add_(updates[k])


def default_optimizer(
    steps: int, peak_lr: float = 1e-4, warmup_frac: float = 0.1,
    weight_decay: float = 1e-5,
) -> AdamW:
    """AdamW under a linear-warmup + cosine-decay schedule with the gradient
    clipped at global norm 1 — the JAX package's fine-tuning recipe."""
    warmup = max(1, int(steps * warmup_frac))
    schedule = warmup_cosine_decay_schedule(
        init_value=peak_lr * 1e-2, peak_value=peak_lr,
        warmup_steps=warmup, decay_steps=max(steps, warmup + 1),
    )
    return AdamW(schedule, weight_decay=weight_decay)
