#!/usr/bin/env python3
"""The port's stencil kernels (K2, K3, K2ᵀ, K3ᵀ) against another checkout's,
in turns, on one GPU.

    python3 tools/stencil_turns.py PARENT_DIR [--sweep] [--step]

PARENT_DIR is another checkout of this repository, for example a commit
unpacked with ``git archive <commit> | tar -x -C build/parent`` (``build/``
is ignored by git). Its ``lungmask_tpu_torch/ops/kernels/stencil.py`` is
loaded as a module of its own and its ``csrc/stencil.cu`` built into
``lungmask_tpu_torch/_build/libstencil_parent.so``, so both wrappers run in
one process on one card. At each bf16 shape the U-Net gives the stencils
(a 32-slice inference chunk, a train step of batch 8), both kernels are held
bit-equal to this tree's plain version, then timed in the order parent,
this, this, parent: back to back (the median of CUDA-event runs of 20
calls), the card's own ms per launch (``torch.profiler``, one window) and
the host's µs per call (``chip_smoke._host_us``); the sums per chunk and per
step follow. ``--sweep`` also runs K3ᵀ under other tile plans at the same
shapes; ``--step`` times the bf16 train step with each tree's stencils in
turns. Last, the host's µs per call of each part of a wrapper call at the
train step's smallest K3ᵀ shape (medians of rounds of 200 calls, each
round synchronised). Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import math
import os
import sys
import time
import types
from dataclasses import replace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

# (rows, tile_w, vectors per slab) of K3ᵀ's tile plans that --sweep tries
# beside up2_bwd_plan's.
SWEEP = [(8, 4, 32), (4, 4, 32), (8, 2, 32), (8, 3, 32), (8, 4, 16), (8, 3, 16), (16, 4, 16),
         (8, 4, 8), (16, 8, 8), (32, 4, 4)]
PART_ROUNDS = 10
STEP_ROUNDS, STEP_RUNS = 3, 10  # train-step turns: 4 turns a round, runs a turn


def load_parent(parent: str):
    """The parent checkout's stencil module, building its own source into a
    library of another name."""
    from lungmask_tpu_torch.ops.kernels import _nvcc

    path = os.path.join(parent, "lungmask_tpu_torch", "ops", "kernels", "stencil.py")
    spec = importlib.util.spec_from_file_location("stencil_parent", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    mod.SOURCE = os.path.join(parent, "lungmask_tpu_torch", "csrc", "stencil.cu")
    mod._nvcc = types.SimpleNamespace(build=lambda src, name: _nvcc.build(src, name + "_parent"))
    return mod


def cases(torch, st, gen, dev):
    """(kernel name, per, shape, input, plain output, a maker of one call
    of a module's wrapper, bound ms) at every bf16 timed shape. Operations
    per output element as chip_smoke counts them."""
    out = []
    for per, pools, ups in (("chunk", cs.POOL_SHAPES, cs.UP_SHAPES),
                            ("step", cs.TRAIN_POOL_SHAPES, cs.TRAIN_UP_SHAPES)):
        for shape, pool in [(s, True) for s in pools] + [(s, False) for s in ups]:
            n, h, w, c = shape
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            if pool:
                g = torch.randn((n, h // 2, w // 2, c), generator=gen, device=dev)
                g = g.to(torch.bfloat16)
                items = [("avg_pool2", x, st.avg_pool2_reference(x),
                          lambda m, x=x: lambda: m.avg_pool2(x), 4),
                         ("avg_pool2_bwd", g, st.avg_pool2_bwd_reference(g, shape),
                          lambda m, g=g, s=shape: lambda: m.avg_pool2_bwd(g, s), 1)]
            else:
                g = torch.randn((n, 2 * h, 2 * w, c), generator=gen, device=dev)
                g = g.to(torch.bfloat16)
                items = [("bilinear_up2", x, st.bilinear_up2_reference(x),
                          lambda m, x=x: lambda: m.bilinear_up2(x), 18 / 4),
                         ("bilinear_up2_bwd", g, st.bilinear_up2_bwd_reference(g),
                          lambda m, g=g: lambda: m.bilinear_up2_bwd(g), 21)]
            for name, inp, want, call, ops_per_out in items:
                nbytes = (inp.numel() + want.numel()) * inp.element_size()
                bound, _ = cs._bound(nbytes, want.numel() * ops_per_out)
                out.append((name, per, shape, inp, want, call, bound))
    return out


def bits(torch, t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def turns(torch, st, parent, rows):
    """Both modules' wrappers at every row: bit-equal to the plain version,
    then their three readings per shape and summed per chunk and step."""
    mods = {"parent": parent, "this": st}
    for name, per, shape, _, want, call, _ in rows:
        for label, m in mods.items():
            got = call(m)()
            torch.cuda.synchronize()
            if not torch.equal(bits(torch, got), bits(torch, want)):
                raise AssertionError(f"{label} {name} {shape} differs from the plain version")
    fns = [(name, label, call(m)) for name, *_, call, _ in rows for label, m in mods.items()]
    device = dict(zip([(i, label) for i in range(len(rows)) for label in mods],
                      cs._device_ms(torch, [(f"{name}_kernel", fn) for name, _, fn in fns])))
    sums = {}
    for i, (name, per, shape, _, _, call, bound) in enumerate(rows):
        med = cs._in_turns(torch, {"parent": call(parent), "this": call(st)})
        line = []
        for label, m in mods.items():
            host = cs._host_us(torch, call(m))
            dev_ms = device[(i, label)]
            t = sums.setdefault((name, per, label), [0.0, 0.0, 0.0, 0.0])
            t[0] += med[label]
            t[1] = None if dev_ms is None or t[1] is None else t[1] + dev_ms
            t[2] += host
            t[3] += bound
            line.append(f"{label}: {cs._readings(med[label], dev_ms, host)}")
        print(f"[turns] {name} {shape} bf16, bound {bound:.4f} ms | " + " || ".join(line),
              flush=True)
    for (name, per, label), (ms, dev_ms, host, bound) in sums.items():
        share = "" if dev_ms is None else f", of the device time {bound / dev_ms:.1%}"
        print(f"[turns] {name} per {per} ({label}): {cs._readings(ms, dev_ms, host, True)} | "
              f"bound {bound:.4f} ms, share {bound / ms:.1%}{share}")


def sweep(torch, st, rows):
    """K3ᵀ under up2_bwd_plan's plan and the SWEEP plans: bit-equal, back
    to back through _launch into one output, and the card's own time."""
    groups, labels = [], []
    for name, per, shape, g, want, _, bound in rows:
        if name != "bilinear_up2_bwd":
            continue
        base = st.up2_bwd_plan(shape, 2)
        plans = [base] + [
            replace(base, rows=r, tile_w=tw, cvt=cvt, threads=cvt * min(r, 256 // cvt))
            for r, tw, cvt in SWEEP
            if (r, tw, cvt) != (base.rows, base.tile_w, base.cvt) and cvt <= shape[3] // base.vec]
        dx = torch.empty(shape, dtype=g.dtype, device=g.device)
        for p in plans:
            if p.smem_bytes > st.SMEM_LIMIT or p.threads > st.UP2_MAX_THREADS:
                continue
            fn = (lambda g=g, dx=dx, p=p, s=shape:
                  st._launch("lm_bilinear_up2_bwd", g, dx, *p.args, shape=s))
            fn()
            torch.cuda.synchronize()
            if not torch.equal(bits(torch, dx), bits(torch, want)):
                raise AssertionError(f"K3ᵀ plan {p} differs at {shape}")
            groups.append((f"{name}_kernel", fn))
            labels.append((shape, p, bound, cs._median_ms(torch, fn)))
    device = cs._device_ms(torch, groups)
    for (shape, p, bound, ms), dev_ms in zip(labels, device):
        dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms ({bound / dev_ms:.1%})"
        blocks = math.prod(p.grid(shape))
        print(f"[sweep] K3ᵀ {shape} rows {p.rows} tile_w {p.tile_w} cvt {p.cvt} threads "
              f"{p.threads} smem {p.smem_bytes} B, {blocks} blocks: back to back {ms:.4f} ms, "
              f"device {dev}, bound {bound:.4f} ms")


def parts(torch, st, parent):
    """The host's µs per call of each part of a K3ᵀ wrapper call."""
    from lungmask_tpu_torch.ops.kernels import count_launch

    dev = torch.device("cuda", 0)
    shape = (cs.TRAIN_BATCH, 16, 16, 1024)
    g = torch.randn((shape[0], 32, 32, shape[3]), device=dev).to(torch.bfloat16)
    dx = torch.empty(shape, dtype=g.dtype, device=dev)
    p = st.up2_bwd_plan(shape, 2)
    lib = st.build()
    parent.build()
    counter = types.SimpleNamespace(launches=0)
    items = {
        "torch.empty (dx)": lambda: torch.empty(shape, dtype=g.dtype, device=g.device),
        "g.new_empty (dx)": lambda: g.new_empty(shape),
        "g.device": lambda: g.device,
        "g.get_device()": lambda: g.get_device(),
        "torch.cuda.current_stream(g.device).cuda_stream":
            lambda: torch.cuda.current_stream(g.device).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(0)": lambda: torch._C._cuda_getCurrentRawStream(0),
        "_checked(g)": lambda: st._checked(g, "x"),
        "count_launch (lock)": lambda: count_launch(counter),
        "up2_bwd_plan (cached)": lambda: st.up2_bwd_plan(shape, 2, True),
        "the plan as the wrapper finds it": lambda: st.up2_bwd_plan(
            shape, g.element_size(), (g.data_ptr() | dx.data_ptr()) % 16 == 0).args,
        "two data_ptr()": lambda: (g.data_ptr(), dx.data_ptr()),
        "ctypes call returning at once (no work)":
            lambda: lib.lm_bilinear_up2_bwd(0, 0, 0, 1, 1, 1, 1, 8, 1, 1, 1, 1, 0, None),
        "_launch (ctypes, launch, check)":
            lambda: st._launch("lm_bilinear_up2_bwd", g, dx, *p.args, shape=shape),
        "bilinear_up2_bwd (this wrapper)": lambda: st.bilinear_up2_bwd(g),
        "bilinear_up2_bwd (parent wrapper)": lambda: parent.bilinear_up2_bwd(g),
        "avg_pool2_bwd (this wrapper)": lambda: st.avg_pool2_bwd(dx, (8, 32, 32, 1024)),
        "avg_pool2_bwd (parent wrapper)": lambda: parent.avg_pool2_bwd(dx, (8, 32, 32, 1024)),
    }
    for label, fn in items.items():
        us = sorted(cs._host_us(torch, fn) for _ in range(PART_ROUNDS))
        print(f"[parts] {label}: {us[len(us) // 2]:.2f} µs per call (median of {PART_ROUNDS} "
              f"rounds of {cs.HOST_CALLS} calls)")


def step_turns(torch, st, parent, rounds: int = STEP_ROUNDS, steps: int = STEP_RUNS):
    """The bf16 train step (batch 8, wf=6, 256², a fresh U-Net, seeded
    images and labels) with the parent's stencils — its wrappers, autograd
    Functions and kernels, swapped into ``models.unet`` — and with this
    tree's, in the order parent, this, this, parent: the median ms of
    ``steps`` warm steps per turn, each synchronised."""
    import numpy as np

    from lungmask_tpu_torch.models import unet
    from lungmask_tpu_torch.train import default_optimizer, init_train_state, make_train_step

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n = cs.TRAIN_BATCH
    im = torch.from_numpy(rng.normal(0, 1, (n, 256, 256, 1)).astype(np.float32)).to(dev)
    lb = torch.from_numpy(rng.integers(0, 3, (n, 256, 256)).astype(np.int32)).to(dev)
    params = unet.init_params(3, generator=torch.Generator().manual_seed(0))
    opt = default_optimizer(1000)
    step = make_train_step(opt, compute_dtype=torch.bfloat16)
    state = init_train_state(params, opt, dev)
    times = {"parent": [], "this": []}
    try:
        for label in ["parent", "this", "this", "parent"] * rounds:
            unet.stencil = parent if label == "parent" else st
            state, _ = step(state, im, lb)
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = step(state, im, lb)
                torch.cuda.synchronize()
                times[label].append(1e3 * (time.perf_counter() - t0))
    finally:
        unet.stencil = st
    for label, ts in times.items():
        ts = sorted(ts)
        print(f"[step] train step (batch {n}, wf=6, bf16, 256²) with {label}'s stencils: median "
              f"{ts[len(ts) // 2]:.3f} ms of {len(ts)} (range {ts[0]:.3f}-{ts[-1]:.3f})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", help="another checkout of the repository")
    ap.add_argument("--sweep", action="store_true", help="also try other K3ᵀ tile plans")
    ap.add_argument("--step", action="store_true",
                    help="also time the train step with each tree's stencils")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("stencil_turns: no CUDA device", file=sys.stderr)
        return 2
    from lungmask_tpu_torch.ops.kernels import stencil as st

    smoke = cs.Smoke(torch)
    smoke.device()
    parent = load_parent(os.path.abspath(args.parent))
    st.build()
    parent.build()
    dev = torch.device("cuda", 0)
    rows = cases(torch, st, torch.Generator(device=dev).manual_seed(9), dev)
    turns(torch, st, parent, rows)
    if args.sweep:
        sweep(torch, st, rows)
    if args.step:
        step_turns(torch, st, parent)
    parts(torch, st, parent)
    print(f"[turns] {smoke.state['smi']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
