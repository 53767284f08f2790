"""The lungmask 2-D U-Net (JoHof/lungmask v0.2.20, ``lungmask/resunet.py``):
the family of every configuration that names none.

A family gives the lanes everything that depends on the model: the seeded
weights of each model of the configuration (:func:`weights`), the port's
inferer on its normal path (:func:`inferer`), the analytic cost of one
volume's forward (:func:`forward_cost`), what the program produced, read
while the inferer is alive (:func:`outputs`), the checks against the
family's reference once the program's state is freed (:func:`checks`), the
CPU test size (:func:`shrink`), and, where it has them, the control and the
fault that ``calibrate.py`` plants (:func:`control`, :func:`fault`) and the
pieces of a training step (``train_*``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from portbench import phantom, roofline, weights as seeded

B1 = 0.9  # Adam's first-moment decay (optax's default, the port's AdamW)
TINY_WF = 3  # the width of the CPU tests (8 → 128 channels)


def weights(run) -> List[Dict[str, np.ndarray]]:
    """The flat float32 tree of each model of the configuration, drawn from
    the seed on the run's device."""
    c = run.config
    return [seeded.make(run.seed, i, depth=c["depth"], wf=c["wf"], n_classes=m["n_classes"],
                        eps=c["perturbation"], eps_head=c["head_perturbation"], device=run.device)
            for i, m in enumerate(c["models"])]


def inferer(run, trees):
    """``LMInferer`` over the trees as ``.npz`` files (the second one the
    fill model), with the traffic's keywords."""
    from lungmask_tpu_torch.inferer import LMInferer

    paths = [seeded.save_npz(os.path.join(run.tmp, f"model{i}.npz"), t)
             for i, t in enumerate(trees)]
    kwargs = dict(run.traffic.get("inferer", {}))
    if run.device.type == "cpu":
        kwargs["force_cpu"] = True
    return LMInferer(modelpath=paths[0], fillmodel_path=paths[1] if len(paths) > 1 else None,
                     tqdm_disable=True, batch_size=run.config["chunk"], **kwargs)


def forward_cost(config: dict, shape, spacing) -> dict:
    """Analytic work and bound of the forward(s) of one volume of ``shape``
    (z, y, x) through every model of the configuration, in chunks of
    ``chunk`` slices."""
    costs = [roofline.forward_cost(int(shape[0]), config["chunk"], depth=config["depth"],
                                   wf=config["wf"], size=config["resolution"],
                                   n_classes=m["n_classes"])
             for m in config["models"]]
    return {"flops": sum(x["flops"] for x in costs), "bound_s": sum(x["bound_s"] for x in costs)}


def _program_maps(inferer, image):
    """``image`` once more through the timed inferer's first two split
    phases (the stages ``apply`` runs): its class map(s) as the host
    receives them, and its boxes."""
    pre = inferer.preprocess_image(image)
    pred = inferer.forward_preprocessed(pre)
    maps = pred if isinstance(pred, tuple) else (pred,)
    return [np.asarray(m) for m in maps], np.asarray(pre["boxes"])


def _chunk_logits(run, inferer, images, i: int):
    """One chunk of pool volume ``i``, drawn from the seed: the reference's
    normalized slices of it, and the class scores that each of the timed
    inferer's runners (its U-Net on the window's kernels, at the window's
    chunk size) gives those slices, float32 (n, H, W, K) on the host."""
    from portbench.reference import pipeline

    n, chunk = images[i].array.shape[0], int(run.config["chunk"])
    start = chunk * int(run.rng.integers(0, -(-n // chunk)))
    x = pipeline.normalized_slices(images[i].array, images[i].direction, start, start + chunk,
                                   run.config["resolution"])
    runners = [r for r in (inferer.model, inferer.fillmodelm) if r is not None]
    with torch.inference_mode():
        xt = torch.as_tensor(x, dtype=torch.float32, device=run.device).unsqueeze(-1)
        return x, [r.model(xt).float().cpu() for r in runners]


def outputs(run, inferer, images, sampled: List[int]) -> dict:
    """What the checks compare, taken while the timed inferer is alive:
    ``chunk`` (:func:`_chunk_logits` of the first sampled volume, or None
    where the window returned no mask) and ``maps`` (:func:`_program_maps`
    of each sampled volume)."""
    chunk = _chunk_logits(run, inferer, images, sampled[0]) if sampled else None
    return {"chunk": chunk, "maps": {i: _program_maps(inferer, images[i]) for i in sampled}}


def _logit_gap(run, x: np.ndarray, got: List[torch.Tensor], trees) -> float:
    """The worst class's gap (``reference.unet.class_gap``: the norm of the
    difference over the scale of the head's terms) between the program's
    class scores and the float32 reference U-Net's, over the
    configuration's models."""
    from portbench.reference import unet

    xt = torch.as_tensor(x, dtype=torch.float32, device=run.device)
    worst = 0.0
    for flat, scores in zip(trees, got):
        p = unet.tensors(flat, run.device)
        with torch.no_grad():
            want, scale = unet.scores(p, xt)
        worst = max(worst, unet.class_gap(scores, want.cpu(), scale))
        del p, want
    return worst


def checks(run, masks, out: dict, images, trees) -> List[list]:
    """Each number beside its limit, over the sampled pool volumes
    (``masks``: the window's masks of each; ``out``: what :func:`outputs`
    returned; a window that returned no mask reads 1 throughout):

    - ``map_mismatch``: the largest share of pixels in which a program class
      map differs from the reference's (its own preprocessing and float32
      U-Net): preprocessing, the U-Net, its argmax and download;
    - ``finish_mismatch``: the largest share of voxels in which a mask of
      the window differs from the reference's postprocessing, paste-back,
      fusion and reorientation of the program's class maps and boxes
      (exact): the host stages after the U-Net;
    - ``logit_gap``: the chunk's class scores (:func:`_logit_gap`).
    """
    from portbench.reference import pipeline

    prog, chunk = out["maps"], out["chunk"]
    map_mm = fin_mm = 0.0 if masks else 1.0
    for i, kept in sorted(masks.items()):
        img = images[i]
        ref_maps, ref_boxes, shape = pipeline.class_maps(img.array, img.direction, trees,
                                                         run.device)
        maps, boxes = prog[i]
        for got, want in zip(maps, ref_maps):
            map_mm = max(map_mm, float(np.mean(got != want)) if got.shape == want.shape else 1.0)
        want = pipeline.finish(maps, boxes, shape, img.direction)
        for m in kept:
            fin_mm = max(fin_mm, float(np.mean(m != want)) if m.shape == want.shape else 1.0)
        if run.look:  # the whole pipeline's mask against the window's (calibration only)
            ref = pipeline.finish(ref_maps, ref_boxes, shape, img.direction)
            run.looked["mask_mismatch"] = max([run.looked.get("mask_mismatch", 0.0)]
                                              + [float(np.mean(m != ref)) for m in kept])
    gap = _logit_gap(run, chunk[0], chunk[1], trees) if chunk is not None else 1.0
    return [["map_mismatch", map_mm, run.limit("map_mismatch")],
            ["finish_mismatch", fin_mm, run.limit("finish_mismatch")],
            ["logit_gap", gap, run.limit("logit_gap")]]


def shrink(cell: dict) -> None:
    """The CPU test size: wf 3, 8 slices of 128² (fine-tuning: 2 volumes of
    16)."""
    cell["config"]["wf"] = TINY_WF
    t = cell["traffic"]
    t["size"] = 128
    if t["lane"] == "finetune":
        t.update(volumes=2, slices=16, warm_steps=4)
    else:
        t["slices"] = 8


# -- the control and the fault of calibrate.py ---------------------------------


def control(r) -> dict:
    """The reference in float8 e4m3 in the program's place against the
    float32 reference: the class maps of a volume and one chunk's class
    scores."""
    from portbench.reference import pipeline, unet

    trees = weights(r)
    tr, chunk = r.traffic, int(r.config["chunk"])
    vol, _ = phantom.volume(r.seed, 0, tr["slices"], tr["size"], r.device)
    start = chunk * int(r.rng.integers(0, -(-tr["slices"] // chunk)))
    x = torch.as_tensor(pipeline.normalized_slices(vol, phantom.RAS, start, start + chunk,
                                                   r.config["resolution"]),
                        dtype=torch.float32, device=r.device)
    gap = 0.0
    with torch.no_grad():
        for flat in trees:
            p = unet.tensors(flat, r.device)
            want, scale = unet.scores(p, x)
            gap = max(gap, unet.class_gap(unet.scores(p, x, unet.fp8_e4m3)[0], want, scale))
            del p
    ref = pipeline.class_maps(vol, phantom.RAS, trees, r.device)[0]
    ctl = pipeline.class_maps(vol, phantom.RAS, trees, r.device, quant=unet.fp8_e4m3)[0]
    return {"map_mismatch": max(float(np.mean(a != b)) for a, b in zip(ctl, ref)),
            "logit_gap": gap}


def zero_deepest(real, config: dict):
    """``real`` (K4's ``conv_stage``) broken: every stage of the U-Net's
    deepest level (``2 ** (wf + depth − 1)`` output channels) returns its
    channels from 3 on as zeros, the three carried ones intact, so the
    masks keep their lung bands."""
    widest = 2 ** (int(config["wf"]) + int(config["depth"]) - 1)

    @functools.wraps(real)  # keeps its launch counter
    def broken(x, w, *args, **kwargs):
        y = real(x, w, *args, **kwargs)
        if w.shape[0] == widest:
            y[..., 3:] = 0
        return y

    return broken


@contextlib.contextmanager
def fault(config: dict):
    """A fault planted in the program for the block: :func:`zero_deepest`
    in K4's place."""
    from lungmask_tpu_torch.ops.kernels import conv_stage as k4

    real = k4.conv_stage
    k4.conv_stage = zero_deepest(real, config)
    try:
        yield
    finally:
        k4.conv_stage = real


# -- the training step (lane finetune) ----------------------------------------


def train_model(run, tree):
    """The port's trainable U-Net from the seeded tree."""
    from lungmask_tpu_torch.models import convert

    return convert.from_jax_params(seeded.nested(tree), run.device)


def flat_tree(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_tree(v, f"{prefix}.{i}"))
        return out
    return {prefix: tree}


def train_readings(tree, state1, params3) -> dict:
    """The program's side of the training checks, by the reference's leaf
    names: the first gradient as the optimizer got it (its first moment
    after step 1 over 1 − β₁), and each parameter's change after step 3."""
    model = state1.model
    grad = {k: float(v.norm()) / (1.0 - B1)
            for k, v in flat_tree(model.tree(of=state1.opt_state.mu)).items()}
    p3 = flat_tree(model.tree(of=params3))
    change = {}
    for k, v in tree.items():
        a = np.asarray(v, np.float32)
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
        change[k] = float((p3[k].float().cpu() - torch.from_numpy(np.ascontiguousarray(a))).norm())
    return {"grad": grad, "change": change}


def train_checks(run, pairs, tree, prog: dict, *, fit_seed: int, n_batches: int) -> List[list]:
    """``loss_gap``, ``grad_gap``, ``change_gap`` of the program's first
    three steps (``prog``: ``loss``, ``grad``, ``change``) against the
    float32 reference's."""
    from portbench.reference import train as ref_train

    tr = run.traffic
    ref = ref_train.first_steps(pairs, tree, batch=int(tr["batch"]), seed=fit_seed,
                                n_batches=n_batches, dice_weight=float(tr["dice_weight"]),
                                lr_swap=tuple(tr["lr_swap"]), size=run.config["resolution"],
                                device=run.device)
    gaps = ref_train.gaps(prog, ref)
    print(f"portbench: {gaps['left_out']} leaves left out of change_gap", file=sys.stderr)
    return [[name, gaps[name], run.limit(name)] for name in ("loss_gap", "grad_gap", "change_gap")]


def train_flops(config: dict, slices: int) -> float:
    """3 × the forward's operations over ``slices`` slices."""
    return 3.0 * roofline.forward_cost(
        slices, slices, depth=config["depth"], wf=config["wf"], size=config["resolution"],
        n_classes=config["models"][0]["n_classes"])["flops"]


def train_control(r) -> dict:
    """The reference's first steps in float8 e4m3 (the control) and with
    half of each batch left out of the loss (a planted fault), against the
    float32 reference."""
    from portbench.reference import train, unet

    tr, c = r.traffic, r.config
    tree = weights(r)[0]
    pairs = phantom.pool(r.seed, tr["volumes"], tr["slices"], tr["size"], r.device)
    n_slices = sum(v.shape[0] for v, _ in pairs)
    kw = dict(batch=int(tr["batch"]), seed=int(r.rng.integers(0, 2**31)),
              n_batches=(n_slices // int(tr["batch"])) * int(tr["epochs"]),
              dice_weight=float(tr["dice_weight"]), lr_swap=tuple(tr["lr_swap"]),
              size=c["resolution"], device=r.device)
    ref = train.first_steps(pairs, tree, **kw)
    return {"control": train.gaps(train.first_steps(pairs, tree, quant=unet.fp8_e4m3, **kw), ref),
            "half_batch": train.gaps(train.first_steps(pairs, tree, keep=kw["batch"] // 2, **kw),
                                     ref)}
