"""Analytic roofline of the R231 U-Net forward on one NVIDIA H100.

    python -m lungmask_tpu_torch.tools.roofline [CHUNK]     (default 32)

Walks the forward's layer schedule (``models/unet.py``: in_channels=1,
depth 5, wf 6, 256² slices, folded BatchNorm, bilinear upsampling + 1×1
projection, the engine's chunk of 32 slices) and counts, per op, the
floating-point operations and the bytes it must move: activations in and
out at 2 bytes (bf16), each once, plus the weights. Those counts are the
model's work whatever implements it, and equal the JAX package's
``tools/roofline.py`` row for row. Each op's bound is the larger of its
operations over the peak rate and its bytes over the memory rate; the sum
of the bounds is the least time the card could take for one chunk.

Peaks: NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit:
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside them,
3.35 TB/s HBM3. The float32 line doubles every activation's bytes and
divides the operations by the float32 rate. A card set below 700 W
(``nvidia-smi --query-gpu=power.limit``) runs below these peaks.

``tools/layer_bench.py`` of this package times each op of this schedule on
the card and reports its share of the op's bound.
"""

from __future__ import annotations

import argparse
from typing import List, NamedTuple

PEAK_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM data sheet, HBM3
BF16 = 2  # bytes per activation element

DEPTH, WF, SIZE, N_CLASSES, IN_CHANNELS = 5, 6, 256, 3, 1


class Op(NamedTuple):
    """One op of the forward at chunk ``n``: ``kind`` is conv (``k``×``k``,
    ``cin``→``cout``), pool, up, concat (``cin`` = the up half's channels),
    head (the 1×1 classifier) or argmax, at ``h``×``w`` (the input's size
    for pool and up, the output's otherwise)."""

    name: str
    kind: str
    n: int
    h: int
    w: int
    cin: int
    cout: int
    k: int
    flops: float
    bytes: float


def _conv(name, kind, n, h, w, cin, cout, k, elem=BF16) -> Op:
    flops = 2.0 * n * h * w * cin * cout * k * k
    # activations in and out; the weights once
    nbytes = elem * n * h * w * (cin + cout) + elem * k * k * cin * cout
    return Op(name, kind, n, h, w, cin, cout, k, flops, float(nbytes))


def _moves(name, kind, n, h, w, c_read, c_write, cin, cout, elem=BF16) -> Op:
    """An op that only moves data: ``c_read`` channels read and
    ``c_write`` written per pixel of ``h``×``w``."""
    return Op(name, kind, n, h, w, cin, cout, 0, 0.0, float(elem * n * h * w * (c_read + c_write)))


def build(n: int = 32, *, depth: int = DEPTH, wf: int = WF, size: int = SIZE,
          n_classes: int = N_CLASSES, elem: int = BF16) -> List[Op]:
    """The forward's ops at chunk ``n``, in the order they run, with
    activations of ``elem`` bytes."""
    chans = [2 ** (wf + i) for i in range(depth)]
    ops: List[Op] = []
    h = w = size
    cin = IN_CHANNELS
    for i, c in enumerate(chans):
        ops.append(_conv(f"enc{i}.conv1 {h}x{w} {cin}->{c}", "conv", n, h, w, cin, c, 3, elem))
        ops.append(_conv(f"enc{i}.conv2 {h}x{w} {c}->{c}", "conv", n, h, w, c, c, 3, elem))
        if i < depth - 1:
            # K2: reads (h, w, c), writes (h/2, w/2, c)
            ops.append(_moves(f"enc{i}.avgpool {h}x{w} c{c}", "pool", n, h, w, c, c // 4,
                              c, c, elem))
            h //= 2
            w //= 2
        cin = c
    for i in reversed(range(depth - 1)):
        c_in, c_out = chans[i + 1], chans[i]
        # K3: reads (h, w, c_in), writes (2h, 2w, c_in)
        ops.append(_moves(f"up{i}.bilinear_up2 {h}x{w} c{c_in}", "up", n, h, w, c_in, 4 * c_in,
                          c_in, c_in, elem))
        h *= 2
        w *= 2
        ops.append(_conv(f"up{i}.proj1x1 {h}x{w} {c_in}->{c_out}", "conv", n, h, w, c_in, c_out,
                         1, elem))
        ops.append(_moves(f"up{i}.concat {h}x{w} c{2 * c_out}", "concat", n, h, w, 2 * c_out,
                          2 * c_out, c_out, 2 * c_out, elem))
        ops.append(_conv(f"dec{i}.conv1 {h}x{w} {2 * c_out}->{c_out}", "conv", n, h, w,
                         2 * c_out, c_out, 3, elem))
        ops.append(_conv(f"dec{i}.conv2 {h}x{w} {c_out}->{c_out}", "conv", n, h, w, c_out, c_out,
                         3, elem))
    ops.append(_conv(f"head.1x1 {h}x{w} {chans[0]}->{n_classes}", "head", n, h, w, chans[0],
                     n_classes, 1, elem))
    ops.append(_moves(f"head.argmax {h}x{w} c{n_classes}", "argmax", n, h, w, n_classes, 1,
                      n_classes, 1, elem))
    return ops


def bound_ms(op: Op, peak_flops: float = PEAK_BF16_FLOPS):
    """(the op's bound in ms, "operations" or "bytes")."""
    t_ops, t_bytes = op.flops / peak_flops * 1e3, op.bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def totals(ops: List[Op], peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The sums over ``ops``: GFLOP, MB, the operations' time, the bytes'
    time and the roofline bound (the sum of each op's larger one), in ms."""
    return {
        "gflop": sum(o.flops for o in ops) / 1e9,
        "mb": sum(o.bytes for o in ops) / 1e6,
        "ops_ms": sum(o.flops for o in ops) / peak_flops * 1e3,
        "bytes_ms": sum(o.bytes for o in ops) / PEAK_BYTES * 1e3,
        "bound_ms": sum(bound_ms(o, peak_flops)[0] for o in ops),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("chunk", nargs="?", type=int, default=32)
    n = ap.parse_args(argv).chunk
    ops = build(n)
    t = totals(ops)
    print(f"chunk={n}  total {t['gflop'] / n:.1f} GFLOP/slice  (H100 SXM peaks: "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, {PEAK_BYTES / 1e12:.2f} TB/s)")
    print(f"{'op':44s} {'GFLOP':>8s} {'MB':>8s} {'ops_us':>8s} {'bytes_us':>8s} {'bound':>10s}")
    for op in ops:
        _, by = bound_ms(op)
        print(f"{op.name:44s} {op.flops / 1e9:8.1f} {op.bytes / 1e6:8.1f} "
              f"{op.flops / PEAK_BF16_FLOPS * 1e6:8.1f} {op.bytes / PEAK_BYTES * 1e6:8.1f} "
              f"{by:>10s}")
    print(f"\nsum: {t['gflop']:.1f} GFLOP, {t['mb']:.1f} MB per {n}-slice chunk")
    print(f"operations' time {t['ops_ms']:.3f} ms | bytes' time {t['bytes_ms']:.3f} ms | "
          f"roofline bound (sum of each op's larger) {t['bound_ms']:.3f} ms per chunk "
          f"-> {n / t['bound_ms'] * 1e3:.0f} slices/s")
    f32 = totals(build(n, elem=4), PEAK_F32_FLOPS)
    print(f"float32 (4-byte activations, {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s): roofline bound "
          f"{f32['bound_ms']:.3f} ms per chunk (operations {f32['ops_ms']:.3f}, bytes "
          f"{f32['bytes_ms']:.3f})")
    return t


if __name__ == "__main__":
    main()
