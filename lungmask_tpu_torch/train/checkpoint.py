"""Training checkpoint/resume: train state ↔ ``.npz`` (counterpart of
``lungmask_tpu.train.checkpoint``).

The file is the JAX package's: one flat ``.npz`` of ``leaf00000``… in JAX's
pytree order and layout for a ``default_optimizer`` state — the parameters
(HWIO kernels, dict keys sorted), Adam's count, ``mu`` and ``nu``, the
schedule's count, then ``step`` — plus a JSON ``__meta__``. So
:func:`load_jax_train_state` resumes on the GPU a fine-tune begun with the
JAX package, and the JAX package's ``load_train_state`` reads the port's
files.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from lungmask_tpu_torch.models import convert, unet
from lungmask_tpu_torch.train.optim import init_state
from lungmask_tpu_torch.train.trainer import TrainState
from lungmask_tpu_torch.utils.device import resolve_device


def _normalize(path: str) -> str:
    """np.savez appends '.npz' to extensionless paths; normalize on both the
    save and load side so the same string round-trips."""
    return path if path.endswith(".npz") else path + ".npz"


def _paths(tree, prefix=()) -> Iterator[tuple]:
    """Leaf paths of a nested dict/list tree in JAX's flattening order
    (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _trees(state: TrainState):
    """The port trees of the state's weights and of its Adam moments: views
    of the tensors the state holds."""
    model, opt = state.model, state.opt_state
    return model.tree(), model.tree(opt.mu), model.tree(opt.nu)


def save_train_state(path: str, state: TrainState, meta: Dict[str, Any] | None = None) -> None:
    path = _normalize(path)
    params, mu, nu = _trees(state)
    paths = list(_paths(params))
    opt = state.opt_state

    def jax_leaves(tree):
        return [convert.to_jax_params(_get(tree, p)) for p in paths]

    leaves = (jax_leaves(params) + [np.int32(opt.count)] + jax_leaves(mu) + jax_leaves(nu)
              + [np.int32(opt.schedule_count), np.int32(state.step)])
    flat = {f"leaf{i:05d}": np.asarray(x) for i, x in enumerate(leaves)}
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **flat)


def _read(path: str) -> Tuple[List[np.ndarray], Dict[str, Any]]:
    path = _normalize(path)
    with np.load(path) as data:
        meta = (
            json.loads(bytes(data["__meta__"]).decode("utf-8"))
            if "__meta__" in data.files
            else {}
        )
        leaves = [data[k] for k in sorted(data.files) if k.startswith("leaf")]
    return leaves, meta


def _fill(state: TrainState, leaves: List[np.ndarray], path: str) -> TrainState:
    params, mu, nu = _trees(state)
    paths = list(_paths(params))
    n_expected = 3 * len(paths) + 3
    if len(leaves) != n_expected:
        raise ValueError(
            f"{path}: checkpoint has {len(leaves)} leaves, template expects "
            f"{n_expected} — model/optimizer configuration mismatch"
        )
    n = len(paths)
    with torch.no_grad():
        for tree, first in ((params, 0), (mu, n + 1), (nu, 2 * n + 1)):
            for i, p in enumerate(paths):
                dst = _get(tree, p)
                src = convert.from_jax_params(leaves[first + i])
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{path}: leaf {first + i} ({'.'.join(map(str, p))}) has "
                                     f"shape {tuple(src.shape)}, expected {tuple(dst.shape)}")
                dst.copy_(src)
    state.opt_state.count = int(leaves[n])
    state.opt_state.schedule_count = int(leaves[3 * n + 1])
    state.step = int(leaves[3 * n + 2])
    return state


def load_train_state(path: str, template: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore a state saved by :func:`save_train_state` (or by the JAX
    package's for ``default_optimizer``) into ``template`` — a state of the
    same model configuration (``init_train_state``) — and return it."""
    leaves, meta = _read(path)
    return _fill(template, leaves, _normalize(path)), meta


def load_jax_train_state(path: str, device=None) -> Tuple[TrainState, Dict[str, Any]]:
    """A JAX ``save_train_state`` file written for ``default_optimizer`` (or
    one of this module's) as a port train state on ``device`` (CUDA unless
    ``"cpu"``); the U-Net's depth, width and classes come from the file's
    leaves."""
    leaves, meta = _read(path)
    n = (len(leaves) - 3) // 3
    depth = (n + 8) // 18  # 8 leaves per down block, 10 per up block, 2 in the head
    if len(leaves) != 3 * n + 3 or 18 * depth - 8 != n or depth < 1:
        raise ValueError(f"{_normalize(path)}: {len(leaves)} leaves are not the train state "
                         "of a U-Net under default_optimizer")
    wf = int(np.log2(leaves[0].shape[0]))  # down[0].bn1.bias: 2**wf channels
    n_classes = int(leaves[8 * depth].shape[0])  # last.b
    params = unet.init_params(n_classes, depth=depth, wf=wf, generator=torch.Generator())
    model = unet.UNet(params, torch.float32, trainable=True).to(resolve_device(device))
    state = TrainState(model, init_state(dict(model.named_parameters())), 0)
    return _fill(state, leaves, _normalize(path)), meta
