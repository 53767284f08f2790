"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 -m portbench.calibrate --workload r231.apply --seeds 11 12 13 --control 21 22 23

For each ``--seeds`` seed, one run of the cell (``--seconds`` long) and the
numbers it compares (the program's readings, the lower end of each limit),
with, under ``looked``, the whole pipeline's mask against the reference's
(not compared).
For each ``--control`` seed, the reference in the program's place computed
in the nearest precision below the configuration's (bf16 → float8 e4m3,
:func:`reference.unet.fp8_e4m3`) against the float32 reference (the upper
end): the class maps of a volume and one chunk's class scores; for a
training cell also a planted fault, half of each batch left out of the
loss, against the reference. For each ``--fault`` seed (inference cells),
one run of the cell with the program broken underneath
(:func:`deep_level_zeroed`). Prints one JSON line per reading. Not part of
a benchmark run; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import lanes, phantom, run as runner, spec
from portbench.reference import pipeline, train, unet


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def control_apply(r: lanes.Run) -> dict:
    trees = r.model_trees()
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


def control_finetune(r: lanes.Run) -> dict:
    tr, c = r.traffic, r.config
    tree = r.model_trees()[0]
    pairs = phantom.pool(r.seed, tr["volumes"], tr["slices"], tr["size"], r.device)
    n_slices = sum(v.shape[0] for v, _ in pairs)
    kw = dict(batch=int(tr["batch"]), seed=int(r.rng.integers(0, 2**31)),
              n_batches=(n_slices // int(tr["batch"])) * int(tr["epochs"]),
              dice_weight=float(tr["dice_weight"]), lr_swap=tuple(tr["lr_swap"]),
              size=c["resolution"], device=r.device)
    ref = train.first_steps(pairs, tree, **kw)
    out = {"control": train.gaps(train.first_steps(pairs, tree, quant=unet.fp8_e4m3, **kw), ref),
           "half_batch": train.gaps(train.first_steps(pairs, tree, keep=kw["batch"] // 2, **kw),
                                    ref)}
    return out


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
def deep_level_zeroed(config: dict):
    """A fault planted in the program for the block: :func:`zero_deepest`
    in K4's place."""
    from lungmask_tpu_torch.ops.kernels import conv_stage as k4

    real = k4.conv_stage
    k4.conv_stage = zero_deepest(real, config)
    try:
        yield
    finally:
        k4.conv_stage = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load(), args.workload)
    runner._environment()
    device = torch.device("cuda", 0)
    lane = lanes.LANES[cell["traffic"]["lane"]]
    for seed in args.seeds:
        r = lanes.Run(SimpleNamespace(seed=seed, seconds=args.seconds, trace=0), cell, device,
                      time.perf_counter())
        r.look = True
        try:
            out = lane(r)
        finally:
            r.cleanup()
        _emit(kind="program", seed=seed, **{n: v for n, v, _ in out["checks"]},
              failed=out["failed"], attempted=out["attempted"], looked=r.looked)
        r.free_device()
    for seed in args.fault:
        r = lanes.Run(SimpleNamespace(seed=seed, seconds=args.seconds, trace=0), cell, device,
                      time.perf_counter())
        try:
            with deep_level_zeroed(cell["config"]):
                out = lane(r)
        finally:
            r.cleanup()
        _emit(kind="fault", seed=seed, **{n: v for n, v, _ in out["checks"]})
        r.free_device()
    for seed in args.control:
        r = lanes.Run(SimpleNamespace(seed=seed, seconds=args.seconds, trace=0), cell, device,
                      time.perf_counter())
        t0 = time.perf_counter()
        try:
            res = (control_finetune if cell["traffic"]["lane"] == "finetune" else control_apply)(r)
        finally:
            r.cleanup()
        _emit(kind="control", seed=seed, seconds=time.perf_counter() - t0, **res)
        r.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
