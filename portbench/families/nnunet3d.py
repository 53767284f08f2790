"""nnU-Net's 3-D full-resolution U-Net (MIC-DKFZ/nnUNet v2, ``3d_fullres``;
``portbench/reference/nnunet3d.py``): the family of a configuration with
``"family": "nnunet3d"``.

It gives the lanes what :mod:`portbench.families.unet2d` gives them
(``weights``, ``inferer``, ``forward_cost``, ``outputs``, ``checks``,
``shrink``, ``control``, ``zero_deepest``, ``fault``), and besides the
analytic bytes of the port's two hand-written 3-D kernels a volume
(:func:`kernel_bytes`) and the port's counters (:func:`counters`), which
``lanes_extra/apply_kernels.py`` reads.

Weights (:func:`weights`): drawn from the seed on the run's device in
nnU-Net's parameter names and torch's layouts: He-normal 3×3×3 convs
(std √(2/fan_in)), InstanceNorm scales 1 + 0.1·N(0, 1) and shifts and
every conv bias 0.1·N(0, 1), heads at std √(1/fan_in), transposed convs
at :data:`TRANSP_GAIN`·√(1/fan_in), and the heads' biases
:data:`HEAD_BIAS_SPREAD`·N(0, 1). The normalised features that reach the head
are of unit scale, so its logits are too, and a random projection splits
the phantom's tissues among the classes; the seeded biases move each
class's share with the seed (no class holds most of a volume; PERF.md gives
the shares seen on the card). The transposed convs' gain weighs what comes
up from the deeper levels against the skip beside it in each decoder
level's first conv, as a trained network does: at gain 1 the skips drown
the deep levels, and zeroing the deepest stage moves the logits by no more
than bf16 does (PERF.md §2).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from portbench import roofline

PLAN_KEYS = ("architecture", "in_channels", "features", "convs_per_stage",
             "decoder_convs_per_stage", "kernel", "strides", "norm_eps", "leaky_slope", "patch",
             "spacing", "step", "sigma_scale", "data_order", "logit_order", "n_classes",
             "patches_per_forward", "ct")
# The CPU tests' size: the published depth and kernel, narrow and small
TINY = {"features": [4, 8, 16, 16], "strides": [1, 2, 2, 2], "patch": [32, 32, 32]}
F32, BF16 = 4, 2
# The seeded weights' two constants (no published source defines them): the
# transposed convs' gain over 1/sqrt(fan_in), and the spread of the heads' biases
TRANSP_GAIN = 3.0
HEAD_BIAS_SPREAD = 0.5


def _require_port() -> None:
    """Stop at once, by name, where the port has no 3-D U-Net."""
    if importlib.util.find_spec("lungmask_tpu_torch.models.unet3d") is None:
        raise RuntimeError("portbench: lungmask_tpu_torch has no 3-D U-Net "
                           "(lungmask_tpu_torch/models/unet3d.py); the nnunet3d family cannot run")


def plan(config: dict) -> dict:
    """The model's plan, as its ``.npz`` carries it."""
    return {k: config[k] for k in PLAN_KEYS}


def leaf_shapes(config: dict) -> List[tuple]:
    """(key, shape) of every parameter, in nnU-Net's ``PlainConvUNet``
    ``state_dict`` names."""
    feats, k = list(config["features"]), int(config["kernel"])
    out = []

    def block(prefix, cin, cout):
        out.extend([(f"{prefix}.conv.weight", (cout, cin, k, k, k)), (f"{prefix}.conv.bias", (cout,)),
                    (f"{prefix}.norm.weight", (cout,)), (f"{prefix}.norm.bias", (cout,))])

    cin = int(config["in_channels"])
    for s, c in enumerate(feats):
        for i in range(int(config["convs_per_stage"])):
            block(f"encoder.stages.{s}.0.convs.{i}", cin if i == 0 else c, c)
        cin = c
    for j in range(len(feats) - 1):
        deep, c = feats[-1 - j], feats[-2 - j]
        out += [(f"decoder.transpconvs.{j}.weight", (deep, c, 2, 2, 2)),
                (f"decoder.transpconvs.{j}.bias", (c,))]
        for i in range(int(config["decoder_convs_per_stage"])):
            block(f"decoder.stages.{j}.convs.{i}", 2 * c if i == 0 else c, c)
    for j in range(len(feats) - 1):
        out += [(f"decoder.seg_layers.{j}.weight", (int(config["n_classes"]), feats[-2 - j], 1, 1, 1)),
                (f"decoder.seg_layers.{j}.bias", (int(config["n_classes"]),))]
    return out


def weights(run) -> List[Dict[str, np.ndarray]]:
    """The model's float32 tree drawn from the seed on the run's device (see
    the module's note)."""
    _require_port()
    c = run.config
    gen = torch.Generator(device=run.device).manual_seed(int(run.seed) % 2**63)
    tree = {}
    for key, shape in leaf_shapes(c):
        t = torch.randn(shape, generator=gen, device=run.device, dtype=torch.float32)
        if len(shape) == 5:
            fan_in = (shape[0] if "transpconvs" in key else shape[1]) * math.prod(shape[2:])
            t = t * math.sqrt((2.0 if ".conv." in key else 1.0) / fan_in)
            if "transpconvs" in key:
                t = t * TRANSP_GAIN
        elif "seg_layers" in key:
            t = t * HEAD_BIAS_SPREAD
        elif key.endswith("norm.weight"):
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        tree[key] = t.cpu().numpy()
    return [tree]


def save_npz(path: str, tree: Dict[str, np.ndarray], config: dict) -> str:
    """The tree as the port's ``.npz`` with the plan in its meta."""
    meta = json.dumps({"architecture": config["architecture"], "plan": plan(config)})
    np.savez(path, __meta__=np.frombuffer(meta.encode(), np.uint8), **tree)
    return path


def inferer(run, trees):
    """``LMInferer(modelpath=<.npz>)`` with the traffic's keywords."""
    from lungmask_tpu_torch.inferer import LMInferer

    path = save_npz(os.path.join(run.tmp, "nnunet3d.npz"), trees[0], run.config)
    kwargs = dict(run.traffic.get("inferer", {}))
    if run.device.type == "cpu":
        kwargs["force_cpu"] = True
    return LMInferer(modelpath=path, tqdm_disable=True, precision=run.config["precision"],
                     **kwargs)


# -- the analytic cost ----------------------------------------------------------


def model_shape(config: dict, shape, spacing) -> tuple:
    """The model's grid of an uncropped ``(z, y, x)`` volume of ``spacing``
    ``(x, y, z)``: ``round(shape × spacing / target)`` (the phantom has no
    zero voxel, so nothing is cropped)."""
    sz = tuple(reversed([float(s) for s in spacing]))
    return tuple(int(v) for v in np.round(np.asarray(sz) / float(config["spacing"])
                                          * np.asarray(shape, np.float64)))


def windows(config: dict, grid) -> int:
    """Patches of nnU-Net's sliding window over ``grid``."""
    count = 1
    for n, p in zip(grid, config["patch"]):
        n = max(int(n), int(p))
        count *= int(math.ceil((n - p) / (p * float(config["step"])))) + 1
    return count


def patch_ops(config: dict, n: int = 1) -> List[roofline.Op]:
    """The ops of one forward of ``n`` patches, in bf16 (activations in and
    out at 2 bytes once each, plus the weights): each 3×3×3 conv, each
    InstanceNorm + LeakyReLU (kernel (a): read and write once), each
    transposed conv, concat and the head; then the window's accumulation of
    the patches' logits (bf16 logits read, float32 accumulator read and
    written, the float32 map read)."""
    feats, k = [int(c) for c in config["features"]], int(config["kernel"])
    vox = [math.prod(int(p) for p in config["patch"])]
    for st in config["strides"][1:]:
        vox.append(vox[-1] // int(st) ** 3)
    ops: List[roofline.Op] = []

    def conv(name, v, cin, cout, taps, stride_in=1):
        ops.append(roofline.Op(name, 2.0 * n * v * cin * cout * taps,
                               float(BF16 * n * (v * stride_in * cin + v * cout)
                                     + BF16 * taps * cin * cout)))
        ops.append(roofline.Op(name + ".norm", 0.0, float(2 * BF16 * n * v * cout)))

    cin = int(config["in_channels"])
    for s, c in enumerate(feats):
        for i in range(int(config["convs_per_stage"])):
            conv(f"enc{s}.conv{i}", vox[s], cin if i == 0 else c, c, k ** 3,
                 int(config["strides"][s]) ** 3 if i == 0 else 1)
        cin = c
    for j in range(len(feats) - 1):
        s = len(feats) - 2 - j
        deep, c = feats[s + 1], feats[s]
        ops.append(roofline.Op(f"dec{s}.transp", 2.0 * n * vox[s] * deep * c,
                               float(BF16 * n * (vox[s + 1] * deep + vox[s] * c) + BF16 * 8 * deep * c)))
        ops.append(roofline.Op(f"dec{s}.concat", 0.0, float(2 * BF16 * n * vox[s] * 2 * c)))
        for i in range(int(config["decoder_convs_per_stage"])):
            conv(f"dec{s}.conv{i}", vox[s], 2 * c if i == 0 else c, c, k ** 3)
    kc = int(config["n_classes"])
    ops.append(roofline.Op("head", 2.0 * n * vox[0] * feats[0] * kc,
                           float(BF16 * n * vox[0] * (feats[0] + kc))))
    ops.append(roofline.Op("accumulate", 2.0 * n * vox[0] * kc,
                           float(n * vox[0] * (BF16 * kc + 2 * F32 * kc + F32))))
    return ops


def forward_cost(config: dict, shape, spacing) -> dict:
    """Work and bound of one volume's forward: its patches
    (:func:`patch_ops`) and the division of the accumulator by the weights
    (``patches`` besides)."""
    grid = model_shape(config, shape, spacing)
    n = windows(config, grid)
    ops = patch_ops(config, n)
    vol = math.prod(max(int(g), int(p)) for g, p in zip(grid, config["patch"]))
    kc = int(config["n_classes"])
    ops.append(roofline.Op("divide", 0.0, float(F32 * vol * (2 * kc + 1))))
    return {"flops": sum(o.flops for o in ops), "bound_s": sum(roofline.bound_s(o) for o in ops),
            "patches": n}


def kernel_bytes(config: dict, shape, spacing) -> dict:
    """Bytes a volume's kernels must move: ``norm3d``, every InstanceNorm +
    LeakyReLU of every patch (bf16 read once and written once); ``export``,
    the float32 logits at the model's grid read once and the 4-bit mask of
    the input grid written once."""
    grid = model_shape(config, shape, spacing)
    n = windows(config, grid)
    norm = sum(o.bytes for o in patch_ops(config, n) if o.name.endswith(".norm"))
    kc = int(config["n_classes"])
    per = 2 if kc <= 16 and int(shape[2]) % 2 == 0 else 1
    export = F32 * kc * math.prod(grid) + math.prod(int(s) for s in shape) // per
    return {"norm3d": float(norm), "export": float(export)}


def counters() -> Dict[str, int]:
    """The port's patch counter and the launch counters of its two 3-D
    kernels."""
    _require_port()
    from lungmask_tpu_torch.ops.kernels import export3d, norm3d
    from lungmask_tpu_torch.runtime import sliding_window

    return {"patches": sliding_window.PATCHES.value, "norm3d": norm3d.instance_norm_leaky.launches,
            "export": export3d.export_packed.launches}


# -- what the checks compare ---------------------------------------------------------


def _lps(image):
    from portbench.reference import pipeline

    return np.ascontiguousarray(np.flip(np.asarray(image.array), pipeline.flips(image.direction)))


def outputs(run, inferer, images, sampled: List[int]) -> dict:
    """Each sampled volume once more through the timed inferer's first two
    split phases: its normalised volume at the model's grid, its
    accumulated logits there (float32, on the host), its box and shapes.
    The forwards are counted in ``run.extra_forwards`` for the lane's patch
    count."""
    vols = {}
    for i in sampled:
        pre = inferer.preprocess_image(images[i])
        lg = inferer.forward_preprocessed(pre)
        vols[i] = {"normalized": pre["normalized"].float().cpu().numpy(),
                   "logits": lg.float().cpu().numpy(), "box": tuple(pre["box"]),
                   "crop_shape": tuple(pre["crop_shape"]), "full_shape": tuple(pre["full_shape"])}
        del pre, lg
    run.extra_forwards = getattr(run, "extra_forwards", 0) + len(sampled)
    return {"vols": vols}


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return 1.0
    d = np.linalg.norm((got.astype(np.float64) - want).ravel())
    return float(d / max(np.linalg.norm(want.astype(np.float64).ravel()), 1e-30))


def checks(run, masks, out: dict, images, trees) -> List[list]:
    """Each number beside its limit, over the sampled pool volumes (a window
    that returned no mask reads 1 throughout):

    - ``prep_gap``: ‖program − reference‖ / ‖reference‖ of the normalised
      volume at the model's grid (the reference's preprocessing of the same
      input): the crop, the normalisation and the cubic resample;
    - ``logit_gap``: per class ‖program − reference‖ over the scale of the
      head's terms (``reference.nnunet3d.sliding_window``) of the
      accumulated logits, the float32 reference's sliding window run on the
      program's own normalised volume; the worst class;
    - ``map_mismatch``: the share of voxels of the model's grid whose argmax
      differs between the two (a gate);
    - ``finish_mismatch``: the largest share of voxels in which a mask of
      the window differs from the reference's export (order-1 resample,
      argmax, paste) and reorientation of the program's own logits.
    """
    from portbench.reference import nnunet3d as ref
    from portbench.reference import pipeline

    vols, c = out["vols"], run.config
    if not masks or not vols:
        return [[n, 1.0, run.limit(n)]
                for n in ("prep_gap", "logit_gap", "map_mismatch", "finish_mismatch")]
    p = ref.tensors(trees[0], run.device)
    prep = logit = map_mm = fin = 0.0
    with ThreadPoolExecutor(max_workers=len(vols)) as ex:
        refs = {i: ex.submit(ref.preprocess, _lps(images[i]),
                             tuple(reversed(images[i].spacing)), c) for i in vols}
        for i, v in sorted(vols.items()):
            want, scale = ref.sliding_window(p, v["normalized"], c, run.device)
            logit = max(logit, ref.class_gap(v["logits"], want, scale))
            map_mm = max(map_mm, float(np.mean(v["logits"].argmax(0) != want.argmax(0))))
            del want
    with ThreadPoolExecutor(max_workers=6) as ex:
        for i, v in sorted(vols.items()):
            exported = ref.export(v["logits"], v["box"], v["crop_shape"], v["full_shape"],
                                  map_fn=ex.map)
            back = np.flip(exported, pipeline.flips(images[i].direction))
            for m in masks[i]:
                fin = max(fin, float(np.mean(m != back)) if m.shape == back.shape else 1.0)
            prep = max(prep, _rel(v["normalized"], refs[i].result()[0]))
    return [["prep_gap", prep, run.limit("prep_gap")],
            ["logit_gap", logit, run.limit("logit_gap")],
            ["map_mismatch", map_mm, run.limit("map_mismatch")],
            ["finish_mismatch", fin, run.limit("finish_mismatch")]]


def shrink(cell: dict) -> None:
    """The CPU test size: features 4-16 over four stages, 32³ patches, 2
    patches a forward; two volumes of 48 slices of 128², 48×60×60 at 1.5
    mm (2×3×3 patches, as the full size has)."""
    cell["config"].update(TINY)
    cell["traffic"].update(slices=48, size=128, pool=2)


# -- the control and the faults of calibrate.py -----------------------------------


def control(r) -> dict:
    """The reference in float8 e4m3 in the program's place against the
    float32 reference, on the reference's preprocessing of a pool volume:
    the logits' gap and the argmax's mismatch."""
    from portbench import phantom
    from portbench.reference import nnunet3d as ref
    from portbench.reference import pipeline, unet

    tr, c = r.traffic, r.config
    vol, _ = phantom.volume(r.seed, 0, tr["slices"], tr["size"], r.device)
    lps = np.ascontiguousarray(np.flip(vol, pipeline.flips(phantom.RAS)))
    x, _, _ = ref.preprocess(lps, tuple(reversed(tr["spacing"])), c)
    p = ref.tensors(weights(r)[0], r.device)
    want, scale = ref.sliding_window(p, x, c, r.device)
    got, _ = ref.sliding_window(p, x, c, r.device, quant=unet.fp8_e4m3)
    return {"logit_gap": ref.class_gap(got, want, scale),
            "map_mismatch": float(np.mean(got.argmax(0) != want.argmax(0)))}


def zero_deepest(real, config: dict):
    """``real`` (the port's ``UNet3D.encoder_stage``) broken: the deepest
    stage of the model it runs returns zeros."""

    def broken(self, s, x):
        y = real(self, s, x)
        return torch.zeros_like(y) if s == len(self.features) - 1 else y

    return broken


FAULTS = ("deepest", "uniform", "step", "order1")


@contextlib.contextmanager
def fault(config: dict, kind: str = "deepest"):
    """A fault planted in the port for the block: ``deepest`` (the deepest
    encoder stage zeroed), ``uniform`` (window weights of 1 in place of the
    Gaussian), ``step`` (the window's step 1.0 in place of 0.5), ``order1``
    (the data resampled at order 1 in place of 3)."""
    from lungmask_tpu_torch.models import unet3d
    from lungmask_tpu_torch.ops import resample3d
    from lungmask_tpu_torch.runtime import sliding_window

    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}; one of {FAULTS}")
    target, name = {"deepest": (unet3d.UNet3D, "encoder_stage"),
                    "uniform": (sliding_window, "gaussian_map"),
                    "step": (sliding_window, "compute_steps"),
                    "order1": (resample3d, "zoom")}[kind]
    real = getattr(target, name)
    broken = {
        "deepest": lambda: zero_deepest(real, config),
        "uniform": lambda: (lambda patch, *a, **k: np.ones(tuple(int(p) for p in patch), np.float32)),
        "step": lambda: (lambda size, patch, step: real(size, patch, 1.0)),
        "order1": lambda: (lambda x, shape, order: real(x, shape, 1)),
    }[kind]()
    setattr(target, name, broken)
    try:
        yield
    finally:
        setattr(target, name, real)

