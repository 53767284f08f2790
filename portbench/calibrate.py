"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 -m portbench.calibrate --workload r231.apply --seeds 11 12 13 --control 21 22 23

For each ``--seeds`` seed, one run of the cell (``--seconds`` long) and the
numbers it compares (the program's readings, the lower end of each limit),
with, under ``looked``, the whole pipeline's mask against the reference's
(not compared).
For each ``--control`` seed, the configuration family's control: the
reference in the program's place computed in the nearest precision below
the configuration's against the float32 reference (the upper end; the 2-D
U-Net: bf16 → float8 e4m3, :func:`reference.unet.fp8_e4m3`, on the class
maps of a volume and one chunk's class scores; for a training cell also a
planted fault, half of each batch left out of the loss). For each
``--fault`` seed (inference cells), one run of the cell with the program
broken underneath by the family's fault (:func:`deep_level_zeroed`).
Prints one JSON line per reading. Not part of a benchmark run; needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import torch

# ``reference`` turns TF32 off for the whole calibration, the program's runs included
from portbench import lanes, reference, run as runner, spec  # noqa: F401


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _piece(family, name: str):
    if not hasattr(family, name):
        raise RuntimeError(f"calibrate: family {family.__file__} has no {name}")
    return getattr(family, name)


def control_apply(r: lanes.Run) -> dict:
    """The family's control of an inference cell (2-D U-Net: fp8 class maps
    and one chunk's class scores against the float32 reference)."""
    return _piece(r.family, "control")(r)


def control_finetune(r: lanes.Run) -> dict:
    """The family's control of a training cell and its half-batch fault."""
    return _piece(r.family, "train_control")(r)


def zero_deepest(real, config: dict):
    """``real`` (a kernel of the program) broken as the family's fault
    breaks it (2-D U-Net: K4's deepest level zeroed beyond its carried
    channels)."""
    return _piece(spec.family(config), "zero_deepest")(real, config)


def deep_level_zeroed(config: dict):
    """The family's fault, planted in the program for the block."""
    return _piece(spec.family(config), "fault")(config)


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
    lane = lanes.resolve(cell["traffic"]["lane"])
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
