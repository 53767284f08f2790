"""Seeded U-Net weights at the published widths, made on the device.

The base is a frozen copy of the crafted lung-band parameters of the port's
``models/synthetic.laterality_params``: every conv carries the normalized
intensity v = (HU + 1024) / 1624 through channel 0 (centre-tap identity
kernels, folded-BN scale 1), the first block adds the hinge channels
ReLU(v − θ) for θ at −650 and −400 HU, the decoder keeps them on the
full-resolution skip, and the 1×1 head turns them into band logits: class 2
(the left lung) in [−925, −650) HU, class 1 (the right lung) in [−650,
−400), class 0 elsewhere; classes ≥ 3 sit at −100.

On top of it every conv kernel and every decoder projection get seeded
Gaussian weights of standard deviation ``eps / sqrt(fan_in)`` into every
output channel but the three carried ones (0–2: v and the two hinges), and
the head gets weights of standard deviation ``eps_head / sqrt(fan_in)``
from every channel but those three (``eps`` and ``eps_head`` from the
configuration file). Without them the decoder's projections are zero and
the deep levels carry nothing to the output; with them every one of the 22
conv stages carries data through the free channels into the logits, while
the carried channels stay exact, so the masks stay lung-like: the hinges
enter the head with a slope of 512, and a perturbation of the hinges
themselves would move the bands by far more than a few HU. The
perturbation is drawn with a ``torch.Generator`` on the device in one
call.

Trees use the JAX layout that ``LMInferer(modelpath=<.npz>)`` reads: 4-D
kernels HWIO, keys ``down.<i>.conv1.w`` … ``up.<j>.proj.w`` …
``last.b``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

IN_CHANNELS = 1


def _norm(hu: float) -> float:
    return (min(hu, 600.0) + 1024.0) / 1624.0


def leaf_shapes(depth: int, wf: int, n_classes: int) -> List[Tuple[str, tuple]]:
    """(key, shape) of every leaf, in a fixed order."""
    chans = [2 ** (wf + i) for i in range(depth)]
    out: List[Tuple[str, tuple]] = []

    def block(prefix, cin, cout):
        out.extend([(f"{prefix}.conv1.w", (3, 3, cin, cout)), (f"{prefix}.conv1.b", (cout,)),
                    (f"{prefix}.bn1.scale", (cout,)), (f"{prefix}.bn1.bias", (cout,)),
                    (f"{prefix}.conv2.w", (3, 3, cout, cout)), (f"{prefix}.conv2.b", (cout,)),
                    (f"{prefix}.bn2.scale", (cout,)), (f"{prefix}.bn2.bias", (cout,))])

    prev = IN_CHANNELS
    for i, c in enumerate(chans):
        block(f"down.{i}", prev, c)
        prev = c
    for j, i in enumerate(reversed(range(depth - 1))):
        out.extend([(f"up.{j}.proj.w", (1, 1, prev, chans[i])), (f"up.{j}.proj.b", (chans[i],))])
        block(f"up.{j}.conv_block", 2 * chans[i], chans[i])
        prev = chans[i]
    out.extend([("last.w", (1, 1, prev, n_classes)), ("last.b", (n_classes,))])
    return out


CARRIED = 3  # channels 0-2: v and the hinges at −650 and −400 HU


def make(seed: int, index: int, *, depth: int, wf: int, n_classes: int, eps: float,
         eps_head: float, device: torch.device) -> Dict[str, np.ndarray]:
    """The flat float32 tree of model ``index`` drawn from ``seed``."""
    shapes = leaf_shapes(depth, wf, n_classes)
    sizes = [int(np.prod(s)) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(
        int(np.random.default_rng([int(seed) % 2**63, 1000 + index]).integers(0, 2**62)))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    leaves = dict(zip((k for k, _ in shapes),
                      (t.view(s) for t, (_, s) in zip(torch.split(flat, sizes), shapes))))
    for key, shape in shapes:
        t = leaves[key]
        if key.endswith(".w"):
            head = key == "last.w"
            t.mul_((eps_head if head else eps) / float(np.sqrt(shape[0] * shape[1] * shape[2])))
            if head:
                t[:, :, :CARRIED, :] = 0.0
            elif ".proj." not in key:
                t[..., :CARRIED] = 0.0
        elif key.endswith(".scale"):
            t.fill_(1.0)
        else:
            t.zero_()

    def ident(key, cin=0, cout=0):
        w = leaves[key]
        w[w.shape[0] // 2, w.shape[1] // 2, cin, cout] += 1.0

    t0, t1, t2 = _norm(-925.0), _norm(-650.0), _norm(-400.0)
    hinges = {1: t1, 2: t2}
    for i in range(depth):
        ident(f"down.{i}.conv1.w")
        ident(f"down.{i}.conv2.w")
    for c, theta in hinges.items():
        ident("down.0.conv2.w", 0, c)
        leaves["down.0.conv2.b"][c] = -theta
    for j, i in enumerate(reversed(range(depth - 1))):
        cout = 2 ** (wf + i)
        for c in range(1 + len(hinges)):
            ident(f"up.{j}.conv_block.conv1.w", cout + c, c)
            ident(f"up.{j}.conv_block.conv2.w", c, c)
    a, k = 16.0, 16.0 * 32.0
    w, b = leaves["last.w"], leaves["last.b"]
    b[3:] = -100.0
    w[0, 0, 0, 1] += a
    w[0, 0, 2, 1] += -k
    b[1] = -a * t1
    w[0, 0, 0, 2] += a
    w[0, 0, 1, 2] += -k
    b[2] = -a * t0
    host = flat.cpu().numpy()
    out, at = {}, 0
    for (key, shape), n in zip(shapes, sizes):
        out[key] = host[at:at + n].reshape(shape)
        at += n
    return out


def save_npz(path: str, flat: Dict[str, np.ndarray]) -> str:
    """Write ``flat`` in the ``.npz`` layout ``LMInferer(modelpath=)`` reads."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **flat, __meta__=np.frombuffer(json.dumps({}).encode(), dtype=np.uint8))
    return path


def nested(flat: Dict[str, np.ndarray]) -> dict:
    """The flat tree as nested dicts and lists (``down``, ``up``, ``last``)."""
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)
