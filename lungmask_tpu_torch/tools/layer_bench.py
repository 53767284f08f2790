"""Per-op profile of the R231 U-Net forward on the card.

    python -m lungmask_tpu_torch.tools.layer_bench [CHUNK] [--json OUT.json]
    python -m lungmask_tpu_torch.tools.layer_bench --cpu      (tiny schedule)

Times each op of ``tools/roofline.py``'s schedule (chunk 32 by default) in
isolation, in bf16, through the port's own forward code:

* each 3×3 conv stage (with ReLU + folded-BN affine) and each 1×1
  projection (bias only) as ``models/unet._stage`` runs it in bf16
  inference: one launch of K4 (``ops/kernels/conv_stage``), the float32
  accumulator through the epilogue, one rounding; the row names the route
  that takes it (``conv_stage.route_of``: ``direct`` where cin is under
  8, ``tma``, the wgmma/TMA kernel, where cin is a multiple of 64, else
  ``mma``). Beside it the split the
  port ran before K4 (``conv_stage.conv_stage_cudnn``: the cuDNN bf16 conv,
  then its float32 bias, ReLU, affine and the cast back), the cuDNN conv
  alone (``F.conv2d``), and that split's epilogue as its time less the
  conv's;
* K2 and K3 through ``models/unet._pool`` / ``_up2``, which launch the
  hand-written kernels of ``ops/kernels/stencil`` on a CUDA tensor;
* the concats (``torch.cat`` of two channels_last halves), the head (the
  float32 channel matmul + bias of ``UNet.logits``) and its argmax.

Each op's time is the median over ``RUNS`` (5) CUDA-event timings of
``REPS`` (10) back-to-back calls, after two warm-up calls. The calls cycle through
copies of the op's input whose bytes together exceed twice the H100's
50 MB L2 cache, so each call reads its input from HBM as the roofline
counts it. The whole forward (``unet_argmax`` of a ``UNet`` with the same
schedule) is timed the same way, for the sum of the ops beside it. cuDNN's
settings are the engine's (``cudnn.benchmark`` left at its default, TF32 as
``unet.conv_flags``). Each row gives ms, the achieved TFLOP/s and the
share of the op's roofline bound (``tools/roofline.bound_ms``) that the
time reaches. Times are of the device they ran on, which the output names.

``--cpu`` runs a tiny schedule (depth 3, wf 2, 32², chunk 2 unless given)
on the CPU, where the kernels take their plain versions; its times are the
CPU's and say nothing about the card.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import torch
import torch.nn.functional as F
from torch import nn

from lungmask_tpu_torch.models import unet
from lungmask_tpu_torch.ops.kernels import conv_stage as k4
from lungmask_tpu_torch.tools import roofline
from lungmask_tpu_torch.utils.device import resolve_device

ROTATE_BYTES = 100e6  # twice the H100's 50 MB L2: inputs cycled per call
MAX_COPIES = 16
RUNS, REPS = 5, 10  # timings per op, calls per timing
SEED = 0
TINY = {"depth": 3, "wf": 2, "size": 32, "chunk": 2}  # the --cpu schedule


def _median_ms(fn, device: torch.device) -> float:
    """Median ms per call of ``fn(i)`` (``i`` counts the calls, for the
    input copies) over ``RUNS`` runs of ``REPS`` calls after two warm-up
    calls: CUDA events on a GPU, the host clock on the CPU."""
    cuda = device.type == "cuda"
    for i in range(2):
        fn(i)
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(RUNS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for i in range(REPS):
            fn(i)
        if cuda:
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / REPS)
        else:
            times.append((time.perf_counter() - t0) * 1e3 / REPS)
    return statistics.median(times)


def _copies(nbytes: float) -> int:
    return max(1, min(MAX_COPIES, math.ceil(ROTATE_BYTES / nbytes)))


def _op_fns(op: roofline.Op, dtype, device, gen):
    """(the op as the forward runs it, the cuDNN conv + float32 epilogue or
    None, the cuDNN conv alone or None), each ``fn(i)`` over the ``i``-th
    copy of a seeded random input, and K4's route for a conv stage
    (``conv_stage.route_of``) or None."""

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale)

    def nchw(c, h, w, copies):
        return [rand(op.n, h, w, c).to(dtype).permute(0, 3, 1, 2) for _ in range(copies)]

    if op.kind in ("conv", "head"):
        xs = nchw(op.cin, op.h, op.w, _copies(op.n * op.h * op.w * op.cin * 2))
        wt = rand(op.cout, op.cin, op.k, op.k, scale=(op.cin * op.k * op.k) ** -0.5).to(dtype)
        b, s, t = rand(op.cout), rand(op.cout).abs(), rand(op.cout)
        pad = op.k // 2
        if op.kind == "head":
            wl = wt[:, :, 0, 0].t().contiguous()
            return (lambda i: torch.matmul(xs[i % len(xs)].permute(0, 2, 3, 1).float(),
                                           wl.float()) + b), None, None, None
        holder = nn.Module()  # the stage's weight, as a block holds it
        holder.register_buffer("w", wt)
        aff = (s, t) if op.k == 3 else (None, None)  # the 1×1 projection: bias only
        wk = k4.weight_layout(wt)

        def nhwc(i):
            return xs[i % len(xs)].permute(0, 2, 3, 1)

        return ((lambda i: unet._stage(holder, xs[i % len(xs)], "w", b, *aff)),
                (lambda i: k4.conv_stage_cudnn(nhwc(i), wk, b, *aff, padding=(pad, pad))),
                (lambda i: F.conv2d(xs[i % len(xs)], wt, padding=pad)),
                k4.route_of(nhwc(0), wk))
    if op.kind == "pool":
        xs = nchw(op.cin, op.h, op.w, _copies(op.bytes))
        return (lambda i: unet._pool(xs[i % len(xs)])), None, None, None
    if op.kind == "up":
        xs = nchw(op.cin, op.h, op.w, _copies(op.bytes))
        return (lambda i: unet._up2(xs[i % len(xs)])), None, None, None
    if op.kind == "concat":
        ups = nchw(op.cin, op.h, op.w, _copies(op.bytes))
        skips = nchw(op.cin, op.h, op.w, len(ups))
        return ((lambda i: torch.cat([ups[i % len(ups)], skips[i % len(ups)]], dim=1)),
                None, None, None)
    if op.kind == "argmax":
        xs = [rand(op.n, op.h, op.w, op.cin) for _ in range(_copies(op.bytes))]
        return (lambda i: torch.argmax(xs[i % len(xs)], dim=-1).to(torch.uint8)), None, None, None
    raise ValueError(f"unknown op kind {op.kind}")


def run(chunk: int = 32, *, depth: int = roofline.DEPTH, wf: int = roofline.WF,
        size: int = roofline.SIZE, device=None) -> dict:
    """Time every op of ``roofline.build(chunk, depth=, wf=, size=)`` and the
    whole bf16 forward on ``device`` (CUDA unless ``"cpu"``)."""
    device = resolve_device(device)
    dtype = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(SEED)
    ops = roofline.build(chunk, depth=depth, wf=wf, size=size)
    rows = []
    with torch.inference_mode(), unet.conv_flags(dtype):
        for op in ops:
            whole, split, conv, route = _op_fns(op, dtype, device, gen)
            ms = _median_ms(whole, device)
            bound, by = roofline.bound_ms(op)
            row = {"op": op.name, "kind": op.kind, "ms": ms,
                   "achieved_tflops": op.flops / ms / 1e9, "bound_ms": bound, "bound_by": by,
                   "share": bound / ms}
            if route is not None:
                row["route"] = route
            if conv is not None:
                cudnn_ms, conv_ms = _median_ms(split, device), _median_ms(conv, device)
                row.update(cudnn_ms=cudnn_ms, conv_ms=conv_ms, epilogue_ms=cudnn_ms - conv_ms,
                           conv_achieved_tflops=op.flops / conv_ms / 1e9,
                           conv_share=bound / conv_ms)
            rows.append(row)
            del whole, split, conv, route
        params = unet.init_params(roofline.N_CLASSES, depth=depth, wf=wf,
                                  generator=torch.Generator().manual_seed(SEED))
        model = unet.UNet(params, dtype).to(device).eval()
        xs = [torch.randn(chunk, size, size, 1, generator=gen, device=device)
              for _ in range(2)]
        forward_ms = _median_ms(lambda i: unet.unet_argmax(model, xs[i % 2]), device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"device": name, "chunk": chunk, "depth": depth, "wf": wf, "size": size,
            "dtype": "bfloat16", "runs": RUNS, "reps": REPS, "ops": rows,
            "sum_ms": sum(r["ms"] for r in rows), "forward_ms": forward_ms,
            "roofline_ms": roofline.totals(ops)["bound_ms"]}


def report(result: dict) -> str:
    """The per-op table and its sums, one op per line."""
    lines = [f"device {result['device']} | chunk {result['chunk']} | depth {result['depth']} "
             f"wf {result['wf']} {result['size']}² | {result['dtype']} | median of "
             f"{result['runs']} runs of {result['reps']} calls per op",
             "(conv stages: ms is K4's on the route named after the op; cuDNN+epi the cuDNN "
             "conv with the float32 epilogue the port ran before K4, conv ms the cuDNN conv "
             "alone)",
             f"{'op':44s} {'ms':>9s} {'TFLOP/s':>8s} {'bound ms':>9s} {'share':>7s} "
             f"{'cuDNN+epi':>9s} {'conv ms':>9s} {'epilogue ms':>11s} {'conv share':>10s}"]
    for r in result["ops"]:
        conv = (f"{r['cudnn_ms']:9.4f} {r['conv_ms']:9.4f} {r['epilogue_ms']:11.4f} "
                f"{r['conv_share']:10.1%}" if "conv_ms" in r else "")
        op = f"{r['op']} [{r['route']}]" if "route" in r else r["op"]
        lines.append(f"{op:44s} {r['ms']:9.4f} {r['achieved_tflops']:8.1f} "
                     f"{r['bound_ms']:9.4f} {r['share']:7.1%} {conv}")
    by_kind = {}
    for r in result["ops"]:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + r["ms"]
    convs = [r for r in result["ops"] if "conv_ms" in r]
    lines.append(f"sum of the ops {result['sum_ms']:.4f} ms | the whole forward "
                 f"{result['forward_ms']:.4f} ms | roofline bound {result['roofline_ms']:.4f} ms "
                 f"({result['roofline_ms'] / result['forward_ms']:.1%} of the forward)")
    lines.append("by kind: " + ", ".join(f"{k} {v:.4f} ms" for k, v in by_kind.items())
                 + f" | the conv stages: K4 {sum(r['ms'] for r in convs):.4f} ms; before K4 "
                 f"{sum(r['cudnn_ms'] for r in convs):.4f} ms = cuDNN "
                 f"{sum(r['conv_ms'] for r in convs):.4f} + epilogues "
                 f"{sum(r['epilogue_ms'] for r in convs):.4f}")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("chunk", nargs="?", type=int, default=None)
    ap.add_argument("--json", metavar="OUT", help="write the result as JSON")
    ap.add_argument("--cpu", action="store_true",
                    help="the tiny schedule on the CPU (times are the CPU's)")
    args = ap.parse_args(argv)
    schedule = dict(TINY) if args.cpu else {"chunk": 32}
    if args.chunk is not None:
        schedule["chunk"] = args.chunk
    result = run(schedule.pop("chunk"), device="cpu" if args.cpu else None, **schedule)
    print(report(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.json}")
    return result


if __name__ == "__main__":
    main()
