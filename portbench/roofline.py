"""The yardstick's arithmetic: peaks of one NVIDIA H100 and the analytic
count of the U-Net forward's work.

A frozen copy of the count of the port's ``tools/roofline.py`` (which may
change with the program): per op of one forward at ``n`` slices, the
floating-point operations and the bytes it must move (activations in and
out at 2 bytes, each once, plus the weights). Each op's bound is the larger
of its operations over the bf16 peak and its bytes over the memory rate;
the sum is the least time the card could take.

Peaks: NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W
limit.
"""

from __future__ import annotations

from typing import List, NamedTuple

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BF16 = 2
IN_CHANNELS = 1


class Op(NamedTuple):
    name: str
    flops: float
    bytes: float


def _conv(name, n, h, w, cin, cout, k, elem) -> Op:
    flops = 2.0 * n * h * w * cin * cout * k * k
    nbytes = elem * n * h * w * (cin + cout) + elem * k * k * cin * cout
    return Op(name, flops, float(nbytes))


def _moves(name, n, h, w, c_read, c_write, elem) -> Op:
    return Op(name, 0.0, float(elem * n * h * w * (c_read + c_write)))


def build(n: int, *, depth: int = 5, wf: int = 6, size: int = 256, n_classes: int = 3,
          elem: int = BF16) -> List[Op]:
    """The forward's ops at ``n`` slices of ``size``², in the order they run."""
    chans = [2 ** (wf + i) for i in range(depth)]
    ops: List[Op] = []
    h = w = size
    cin = IN_CHANNELS
    for i, c in enumerate(chans):
        ops.append(_conv(f"enc{i}.conv1", n, h, w, cin, c, 3, elem))
        ops.append(_conv(f"enc{i}.conv2", n, h, w, c, c, 3, elem))
        if i < depth - 1:
            ops.append(_moves(f"enc{i}.avgpool", n, h, w, c, c // 4, elem))
            h //= 2
            w //= 2
        cin = c
    for i in reversed(range(depth - 1)):
        c_in, c_out = chans[i + 1], chans[i]
        ops.append(_moves(f"up{i}.bilinear_up2", n, h, w, c_in, 4 * c_in, elem))
        h *= 2
        w *= 2
        ops.append(_conv(f"up{i}.proj1x1", n, h, w, c_in, c_out, 1, elem))
        ops.append(_moves(f"up{i}.concat", n, h, w, 2 * c_out, 2 * c_out, elem))
        ops.append(_conv(f"dec{i}.conv1", n, h, w, 2 * c_out, c_out, 3, elem))
        ops.append(_conv(f"dec{i}.conv2", n, h, w, c_out, c_out, 3, elem))
    ops.append(_conv("head.1x1", n, h, w, chans[0], n_classes, 1, elem))
    ops.append(_moves("head.argmax", n, h, w, n_classes, 1, elem))
    return ops


def bound_s(op: Op, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    return max(op.flops / peak_flops, op.bytes / PEAK_BYTES)


def totals(ops: List[Op], peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """GFLOP, MB and the bound (the sum of each op's larger time) in ms."""
    return {
        "gflop": sum(o.flops for o in ops) / 1e9,
        "mb": sum(o.bytes for o in ops) / 1e6,
        "bound_ms": sum(bound_s(o, peak_flops) for o in ops) * 1e3,
    }


def forward_cost(n_slices: int, chunk: int, **model) -> dict:
    """Work and bound of one volume's forward in chunks of ``chunk`` slices
    (the last chunk shorter): {"flops", "bound_s"}."""
    flops = bound = 0.0
    for s in range(0, n_slices, chunk):
        ops = build(min(chunk, n_slices - s), **model)
        flops += sum(o.flops for o in ops)
        bound += sum(bound_s(o) for o in ops)
    return {"flops": flops, "bound_s": bound}
