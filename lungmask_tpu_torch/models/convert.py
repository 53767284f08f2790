"""Weights for the port (counterpart of ``lungmask_tpu.models.convert``).

* :func:`from_jax_params` turns the JAX package's numpy parameter tree
  (HWIO conv kernels, folded-BN affines — what ``unet.init_params``,
  ``convert.load_npz`` and ``synthetic.laterality_params`` give) into the
  port's tree of torch tensors (OIHW kernels), so both packages compute the
  same function on the same weights; :func:`to_jax_params` is its inverse
  (fine-tuned weights and gradients back in the JAX layout).
* :func:`load_npz` / :func:`save_npz` read and write the JAX package's flat
  ``.npz`` format unchanged.
* :func:`convert_pth` (:func:`load_pth_state_dict`, then
  :func:`convert_state_dict` and :func:`infer_n_classes`) takes a reference
  ``.pth`` state dict (any variant: production, ``residual``, ``upconv``;
  :func:`detect_config`) through the same BatchNorm fold (eps 1e-5) into
  the HWIO numpy tree, with the JAX package's variant keys (``res``,
  ``bn_pre``, ``upconv``).

Conversion rules (reference U-Net, lungmask/resunet.py): conv kernels are
OIHW in torch and HWIO in the JAX tree; inference-mode BatchNorm folds into
``scale = gamma / sqrt(running_var + eps)``, ``bias = beta - running_mean *
scale``; ``n_classes`` is the length of the final conv bias, the last tensor
of the state dict (lungmask/mask.py:56).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from lungmask_tpu_torch.models.unet import BN_EPS

Params = Dict[str, Any]


def from_jax_params(params: Params, device="cpu") -> Params:
    """JAX-layout numpy tree → port tree of float32 tensors on ``device``:
    4-D kernels HWIO → OIHW (the upconv's (2, 2, in, out) → (out, in, 2,
    2)), everything else as is."""
    if isinstance(params, dict):
        return {k: from_jax_params(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [from_jax_params(v, device) for v in params]
    a = np.asarray(params, dtype=np.float32)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.array(a, order="C")).to(device)  # an owned copy


def to_jax_params(params: Params) -> Params:
    """Port tree of tensors (any device) → JAX-layout numpy float32 tree:
    4-D kernels OIHW → HWIO, everything else as is. The inverse of
    :func:`from_jax_params`; ``save_npz`` of it writes the file both
    packages' ``LMInferer(modelpath=)`` read."""
    if isinstance(params, dict):
        return {k: to_jax_params(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [to_jax_params(v) for v in params]
    a = params.detach().to("cpu", torch.float32).numpy()
    if a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)
    return np.array(a, order="C")  # an owned copy


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _conv(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    w = _to_numpy(sd[prefix + ".weight"]).astype(np.float32)
    b = _to_numpy(sd[prefix + ".bias"]).astype(np.float32)
    return {"w": np.transpose(w, (2, 3, 1, 0)), "b": b}  # OIHW → HWIO


def _folded_bn(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    gamma = _to_numpy(sd[prefix + ".weight"]).astype(np.float64)
    beta = _to_numpy(sd[prefix + ".bias"]).astype(np.float64)
    mean = _to_numpy(sd[prefix + ".running_mean"]).astype(np.float64)
    var = _to_numpy(sd[prefix + ".running_var"]).astype(np.float64)
    scale = gamma / np.sqrt(var + BN_EPS)
    bias = beta - mean * scale
    return {"scale": scale.astype(np.float32), "bias": bias.astype(np.float32)}


def _conv_block(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """Non-residual, batch_norm=True block (the production layout)."""
    return {
        "conv1": _conv(sd, prefix + ".block.0"),
        "bn1": _folded_bn(sd, prefix + ".block.2"),
        "conv2": _conv(sd, prefix + ".block.3"),
        "bn2": _folded_bn(sd, prefix + ".block.5"),
    }


def _res_path(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """The residual 1×1 conv + BN skip path (reference resunet.py:81-82,
    107-114); dead in the production layout, used when residual=True."""
    return {
        "conv": _conv(sd, prefix + ".residual_input_conv"),
        "bn": _folded_bn(sd, prefix + ".residual_batchnorm"),
    }


def _res_conv_block(sd: Mapping[str, Any], prefix: str, first: bool) -> Dict[str, Any]:
    """Residual, batch_norm=True block. The reference's pre-activation
    Sequential (resunet.py:86-106): the first block [Conv, ReLU, BN, Conv]
    (indices 0/2/3), later blocks [ReLU, BN, Conv, ReLU, BN, Conv]
    (indices 1/2/4/5)."""
    if first:
        block = {
            "conv1": _conv(sd, prefix + ".block.0"),
            "bn1": _folded_bn(sd, prefix + ".block.2"),
            "conv2": _conv(sd, prefix + ".block.3"),
        }
    else:
        block = {
            "bn_pre": _folded_bn(sd, prefix + ".block.1"),
            "conv1": _conv(sd, prefix + ".block.2"),
            "bn1": _folded_bn(sd, prefix + ".block.4"),
            "conv2": _conv(sd, prefix + ".block.5"),
        }
    block["res"] = _res_path(sd, prefix)
    return block


def detect_config(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """(depth, residual, up_mode) of a reference-layout state dict, as the
    JAX package reads them: depth counts ``down_path.{i}``; residual iff
    ``down_path.1.block.0.weight`` is missing (the residual layout's later
    blocks open with a ReLU); up_mode ``'upconv'`` iff the transposed conv
    sits at ``up_path.0.up.weight`` (``'upsample'`` wraps Upsample + Conv2d
    as ``up.1``). A batch_norm=False layout raises."""
    depth = 1 + max(
        int(k.split(".")[1]) for k in state_dict if k.startswith("down_path.")
    )
    if depth < 2:
        raise ValueError("state dict has fewer than 2 encoder levels")
    residual = "down_path.1.block.0.weight" not in state_dict
    up_mode = "upconv" if "up_path.0.up.weight" in state_dict else "upsample"
    bn_probe = f"down_path.1.block.{4 if residual else 2}.running_mean"
    if bn_probe not in state_dict:
        raise NotImplementedError(
            "batch_norm=False checkpoints are not supported (all reference "
            "checkpoints use batch_norm=True)"
        )
    return {"depth": depth, "residual": residual, "up_mode": up_mode}


def convert_state_dict(state_dict: Mapping[str, Any], depth: int | None = None) -> Params:
    """Reference-layout torch state dict (any variant with batch_norm=True)
    → JAX-layout numpy tree. The variant is encoded in the tree's keys, as
    the JAX package encodes it: ``res`` (and ``bn_pre`` on every down block
    but the first) for residual, ``upconv`` in place of ``proj`` for the
    transposed-conv up path."""
    cfg = detect_config(state_dict)
    if depth is not None and depth != cfg["depth"]:
        raise ValueError(f"depth mismatch: requested {depth}, found {cfg['depth']}")
    depth = cfg["depth"]
    if cfg["residual"]:
        down = [_res_conv_block(state_dict, f"down_path.{i}", first=(i == 0))
                for i in range(depth)]
    else:
        down = [_conv_block(state_dict, f"down_path.{i}") for i in range(depth)]
    up = []
    for i in range(depth - 1):
        if cfg["up_mode"] == "upconv":
            # ConvTranspose2d weight (in, out, kh, kw) → (kh, kw, in, out).
            w = _to_numpy(state_dict[f"up_path.{i}.up.weight"]).astype(np.float32)
            b = _to_numpy(state_dict[f"up_path.{i}.up.bias"]).astype(np.float32)
            block = {"upconv": {"w": np.transpose(w, (2, 3, 0, 1)), "b": b}}
        else:
            block = {"proj": _conv(state_dict, f"up_path.{i}.up.1")}
        # The up block's own conv block is never residual; the residual
        # path wraps the whole up block (resunet.py:134,149-153).
        block["conv_block"] = _conv_block(state_dict, f"up_path.{i}.conv_block")
        if cfg["residual"]:
            block["res"] = _res_path(state_dict, f"up_path.{i}")
        up.append(block)
    return {"down": down, "up": up, "last": _conv(state_dict, "last")}


def infer_n_classes(state_dict: Mapping[str, Any]) -> int:
    """len() of the last state-dict tensor (the final conv bias), as
    lungmask/mask.py:56 infers it."""
    return len(_to_numpy(list(state_dict.values())[-1]))


def load_pth_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch ``.pth`` checkpoint as numpy arrays (tensors only:
    ``weights_only=True``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _to_numpy(v) for k, v in sd.items()}


def convert_pth(path: str) -> Tuple[Params, int]:
    """Reference ``.pth`` checkpoint → (JAX-layout numpy tree, n_classes)."""
    sd = load_pth_state_dict(path)
    return convert_state_dict(sd), infer_n_classes(sd)


def torch_available() -> bool:
    """Whether ``.pth`` conversion is possible here: always, since the port
    imports torch (the JAX package's counterpart probes for it)."""
    return True


def flatten_params(params: Params) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}

    def add(prefix: str, tree) -> None:
        if isinstance(tree, dict):
            for k, v in tree.items():
                add(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                add(f"{prefix}.{i}", v)
        else:
            flat[prefix] = np.asarray(tree)

    add("", params)
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray]) -> Params:
    """Inverse of :func:`flatten_params`: dot-separated paths, all-digit
    components become list indices."""
    nested: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = nested
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(nested)


def save_npz(path: str, params: Params, meta: Dict[str, Any] | None = None) -> None:
    """Write the JAX package's ``.npz`` format (atomic: tmp + rename)."""
    flat = flatten_params(params)
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode("utf-8"), dtype=np.uint8
    )
    tmp = path + ".part"
    np.savez(tmp, **flat)
    saved = tmp if os.path.exists(tmp) else tmp + ".npz"  # savez may append
    os.replace(saved, path)


def load_npz(path: str) -> Tuple[Params, Dict[str, Any]]:
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files if k != "__meta__"}
        meta = (
            json.loads(bytes(data["__meta__"]).decode("utf-8"))
            if "__meta__" in data.files
            else {}
        )
    return unflatten_params(flat), meta
