"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits 2 without a result where CUDA is missing or the cell asks for more
cards than there are, and 3 where the JAX package or JAX was loaded. With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, ``device.busy_s``/``window_s`` and a
``breakdown`` of the trace. The numbers that decide ``correct`` are printed
beside their limits as the last lines of standard error and under
``checks``, the line's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lungmask_tpu")


def _environment() -> None:
    """Caches inside the checkout (fixed paths) or under ``$TMPDIR``."""
    from portbench.spec import ROOT

    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["LUNGMASK_TPU_CACHE"] = os.path.join(tempfile.gettempdir(), "portbench-weights")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def result_line(run, out: dict, device: dict) -> dict:
    from portbench import spec, tracing

    checks = out["checks"]
    correct = out["failed"] == 0 and all(v <= lim for _, v, lim in checks)
    line = {"correct": bool(correct), "attempted": int(out["attempted"]),
            "failed": int(out["failed"])}
    if run.trace:
        ctx = dict(out["ctx"])
        ctx["trace"] = out["trace"]
        line["metrics"] = spec.read_layer_metrics(run.cell["per_layer"], ctx)
        if out["trace"] is not None:
            device["busy_s"] = tracing.busy_s(out["trace"])
            device["window_s"] = tracing.window_s(out["trace"])
            line["breakdown"] = {"device_ops": tracing.top_ops(out["trace"]),
                                 "idle_gaps": tracing.idle_gaps(out["trace"])}
    else:
        values = dict(out["e2e"], setup_s=run.setup_s)
        line["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                           for m in run.cell["end_to_end"]}
    line["device"] = device
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line


def main(argv=None, *, require_chip: bool = True, adjust=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec

    cell = spec.cell(spec.load(), args.workload)
    _environment()
    import torch

    chips = int(cell["workload"]["chips"])
    if require_chip:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: the cell needs {chips} CUDA device(s), found {n}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    else:
        device = torch.device("cpu")
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    if adjust is not None:
        adjust(cell)

    from portbench import lanes

    lane = lanes.resolve(cell["traffic"]["lane"])
    run = lanes.Run(args, cell, device, T_START)
    try:
        out = lane(run)
    finally:
        run.cleanup()
    info["memory_peak_bytes"] = out["memory_peak_bytes"]
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}; the port's run may not", file=sys.stderr)
        return 3
    line = result_line(run, out, info)
    print("set-up " + ", ".join(f"{n} {v:.3f} s" for n, v in run.phases), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
