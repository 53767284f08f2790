#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lungmask_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel of the port from the sources in this checkout (K1, the
bodymask; K2 and K3, the U-Net's pooling and upsampling; all nvcc builds
started together), checks each against its plain PyTorch version on the
card, then drives two paths at the production width (U-Net wf=6) on a
192-slice 512² lung phantom made from a seed, with crafted weights:

* the fused two-model path — ``LMInferer(modelname="LTRCLobes",
  fillmodel="R231")`` and the CLI's ``--modelname LTRCLobes_R231``, both
  models from a temporary ``$LUNGMASK_TPU_CACHE``;
* the main path — ``LMInferer(...).apply`` and the ``lungmask-torch INPUT
  OUTPUT`` CLI with their defaults (hybrid preprocessing, bf16 U-Net, exact
  host postprocessing);
* device postprocessing — ``LMInferer(postprocessing_mode="device")``,
  single model and fused, its cleanup of one class map on the card held
  bit for bit against the same cleanup on the CPU, and its masks compared
  with the exact path's (``metrics.compare_masks``);
* the cohort lane — ``run_cohort`` over four phantom NIfTI files, exact and
  device mode, every mask equal to ``apply``'s;
* the serve lane — ``make_server`` in this process, three NIfTI uploads from
  two client threads, every response equal to ``apply``'s.

Each path's calls run with every kernel's launch count set to 0 just before
them and read just after. Kernel times are CUDA-event medians over runs of
20 back-to-back launches (so the wrapper's host work between launches stays
out of the window), beside each kernel's bound: the larger of its bytes
over 3.35 TB/s and its operations over 67 TFLOP/s (float32, no tensor
cores), the H100 SXM's published peaks.

Phases: device, build, kernel, unet, stencil, fused, inferer, cli, postdev,
cohort, serve; each prints its results on its own lines. The second-to-last line is a JSON
object describing the kernels; the last line is ``{"ok": true, "device":
{...}}`` and is printed only when every phase passed. Exits non-zero,
printing no result, when no CUDA device is available or any phase fails.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

K1_SOURCE = "lungmask_tpu_torch/csrc/bodymask.cu"
K1_REPLACES = "lungmask_tpu/ops/pallas/bodymask.py:136"
STENCIL_SOURCE = "lungmask_tpu_torch/csrc/stencil.cu"
K2_REPLACES = "lungmask_tpu/ops/pallas/stencil.py:58"
K3_REPLACES = "lungmask_tpu/ops/pallas/stencil.py:126"
CHUNK = 32  # the engine's default batch: 192 slices are 6 chunks
# The U-Net's stencil inputs per chunk at wf=6 (NHWC): its four pools and
# its four upsamples.
POOL_SHAPES = [(CHUNK, 256, 256, 64), (CHUNK, 128, 128, 128), (CHUNK, 64, 64, 256),
               (CHUNK, 32, 32, 512)]
UP_SHAPES = [(CHUNK, 16, 16, 1024), (CHUNK, 32, 32, 512), (CHUNK, 64, 64, 256),
             (CHUNK, 128, 128, 128)]
ODD_SHAPES = [(3, 33, 35, 4), (2, 17, 9, 12), (1, 3, 3, 5), (2, 8, 8, 3)]
# K3 at shapes that straddle its tiles, and at the U-Net's upsamples of a
# 96² volume's host-preprocessed stack (96² slices reach K3 at 6² to 48²).
TILE_SHAPES = [(2, 37, 70, 24), (1, 5, 129, 136), (1, 1, 1, 8), (1, 1, 3, 5)]
VOLUME96_SHAPES = [(2, 6, 6, 1024), (2, 12, 12, 512), (2, 24, 24, 256), (2, 48, 48, 128)]
K1_BATCHES = (1, 192, 193)
REPS = 20  # back-to-back launches per CUDA-event pair
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
UNET_LOGIT_ATOL, UNET_LOGIT_RTOL = 1e-3, 1e-4  # GPU f32 (TF32 off) vs CPU f32
BF16_MIN_AGREEMENT = 0.98  # GPU bf16 argmax vs GPU f32, a gross check
LUNG_MIN_FRACTION = 0.95  # share of each phantom lung given its class
COHORT_SLICES = (192, 160, 128, 96)  # the four cohort volumes: phantom[:n]
SERVE_SLICES = (192, 128, 96)  # the three uploads


def _times_ms(torch, fn, runs: int, reps: int = REPS) -> list:
    """``runs`` timings of one call of ``fn`` in ms, after a warm-up: each
    the CUDA-event time of ``reps`` back-to-back calls, divided by
    ``reps``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def _median_ms(torch, fn, runs: int = 10, reps: int = REPS) -> float:
    import numpy as np

    return float(np.median(_times_ms(torch, fn, runs, reps)))


def _bound(nbytes: float, ops: float):
    """(bound ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _in_turns(torch, fns: dict, runs: int = 5) -> dict:
    """Median ms of each of ``fns``, ``runs`` timings each in one order and
    ``runs`` in the reverse order."""
    import numpy as np

    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k] += _times_ms(torch, fns[k], runs)
    return {k: float(np.median(v)) for k, v in times.items()}


def _ptxas_lines(report: str) -> list:
    """One line per kernel from ptxas's report: name<dtype,vector>,
    registers, spills."""
    import re

    lines, name = [], None
    for ln in report.splitlines():
        m = re.search(r"entry function '.*?(bodymask_kernel|avg_pool2_kernel|bilinear_up2_kernel)"
                      r"(?:I(13__nv_bfloat16|f)Li(\d+)E)?", ln)
        if m:
            spill = "spills not reported"
            name = m.group(1) + (f"<{'bf16' if m.group(2) != 'f' else 'f32'},{m.group(3)}>"
                                 if m.group(2) else "")
        elif name and "spill" in ln:
            spill = ",".join(ln.split(",")[1:]).strip()
        elif name and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            lines.append(f"{name}: {regs.group(1) if regs else '?'} registers, {spill}")
            name = None
    return lines


def _random_slices(seed: int, b: int):
    """(b, 128, 128) float32 HU: noise around −500 HU, rings with cavities,
    bodies with blobs touching the border, thresholded noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:128, 0:128]
    out = np.full((b, 128, 128), -1000, dtype=np.float32)
    for i in range(b):
        kind = i % 4
        if kind == 0:
            out[i] = rng.normal(-500, 300, (128, 128))
        elif kind == 1:
            r = np.hypot(yy - 64 - rng.integers(-20, 20), xx - 64 - rng.integers(-20, 20))
            out[i][(r > 15 + i % 7) & (r < 35 + i % 11)] = 0
            out[i][(r > 45) & (r < 49)] = 0
            out[i][rng.random((128, 128)) < 0.05] = 0
        elif kind == 2:
            body = ((yy - 64) / 45.0) ** 2 + ((xx - 64) / (25.0 + i % 17)) ** 2 < 1
            out[i][body] = 40
            out[i, 55:70, 58:66] = -900  # cavity
            out[i, 0 : 5 + i % 9, 40:80] = 100  # blob on the border
            out[i, 100:128, 0 : 3 + i % 5] = 100
        else:
            out[i] = np.where(rng.random((128, 128)) < 0.3 + 0.02 * (i % 10), 0, -1000)
    return out + rng.normal(0, 20, out.shape).astype(np.float32)


def _random_params(seed: int, n_classes: int = 3):
    """Production-width U-Net weights from a numpy seed: convs
    U(±1/√fan_in) as torch's default init, folded-BN affines around
    identity, a widened head without bias so the class varies by pixel.
    Unlike the crafted weights, every level and both stencils reach the
    logits."""
    import numpy as np

    from lungmask_tpu_torch.models import synthetic

    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, list):
            return [fill(v) for v in node]
        if "w" in node:
            bound = 1.0 / np.sqrt(np.prod(node["w"].shape[:3]))
            return {k: rng.uniform(-bound, bound, v.shape).astype(np.float32)
                    for k, v in node.items()}
        if "scale" in node:
            return {"scale": rng.uniform(0.5, 1.5, node["scale"].shape).astype(np.float32),
                    "bias": rng.uniform(-0.2, 0.2, node["bias"].shape).astype(np.float32)}
        return {k: fill(v) for k, v in node.items()}

    params = fill(synthetic.zero_params(n_classes))
    params["last"]["w"] *= 64.0
    params["last"]["b"][:] = 0.0
    return params


def _kernels():
    """The launch-counted wrappers: K1, K2, K3."""
    from lungmask_tpu_torch.ops.kernels import bodymask, stencil

    return {
        "bodymask_labels": bodymask.bodymask_labels,
        "avg_pool2": stencil.avg_pool2,
        "bilinear_up2": stencil.bilinear_up2,
    }


def _reset_launches() -> None:
    for fn in _kernels().values():
        fn.launches = 0


def _launches() -> dict:
    return {name: fn.launches for name, fn in _kernels().items()}


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures = []
        self.state = {}

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            print(f"[{name}] ok in {time.perf_counter() - t0:.3f} s", flush=True)
        except Exception as e:  # a failed phase is reported, the run goes on
            traceback.print_exc()
            print(f"[{name}] FAILED: {type(e).__name__}: {e}", flush=True)
            self.failures.append(name)

    def check(self, cond, what):
        if not cond:
            raise AssertionError(what)

    # -- phases ---------------------------------------------------------------

    def device(self):
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
        self.check(line, f"nvidia-smi failed: {smi.stderr.strip()}")
        self.state["smi"] = line
        print(line)
        print(
            f"[device] {torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()} "
            f"| python {sys.version.split()[0]} | torch {torch.__version__} "
            f"| cuda {torch.version.cuda}"
        )

    def build(self):
        from lungmask_tpu_torch.ops import native
        from lungmask_tpu_torch.ops.kernels import bodymask as k1
        from lungmask_tpu_torch.ops.kernels import stencil

        def timed(fn):
            t0 = time.perf_counter()
            out = fn()
            return out, time.perf_counter() - t0

        # One compiler per source, all started together.
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=3) as ex:
            jobs = [ex.submit(timed, fn) for fn in (k1.build, stencil.build, native.native_loaded)]
            (_, t_k1), (_, t_st), (loaded, t_host) = [job.result() for job in jobs]
        wall = time.perf_counter() - t0
        print(f"[build] K1 nvcc {t_k1:.2f} s | K2+K3 nvcc {t_st:.2f} s | host core g++ "
              f"{t_host:.2f} s | all, in parallel, {wall:.2f} s")
        from lungmask_tpu_torch.ops.kernels import _nvcc

        for lib in ("libbodymask", "libstencil"):
            for line in _ptxas_lines(_nvcc.ptxas_report(lib)):
                print(f"[build] ptxas {line}")
        self.check(loaded, "the native host core did not build or load")

    def kernel(self):
        torch = self.torch
        from lungmask_tpu_torch.models.synthetic import (
            BODYMASK_EDGE_CASES,
            bodymask_edge_slices,
            lung_phantom,
        )
        from lungmask_tpu_torch.ops.kernels import bodymask as k1
        from lungmask_tpu_torch.transforms import preprocess

        dev = torch.device("cuda", 0)
        vol = lung_phantom(192)
        self.state["phantom"] = vol
        packed = torch.from_numpy(preprocess.pack_bodymask_bits(vol)).to(dev)
        phantom = preprocess.smalls_from_packed(packed).float()
        random64 = torch.from_numpy(_random_slices(1, 64)).to(dev)
        inputs = {"random64": random64,
                  **{f"phantom{b}": torch.cat([phantom, random64])[:b] for b in K1_BATCHES}}
        edge = torch.from_numpy(bodymask_edge_slices()).to(dev)
        inputs.update({name: edge[i : i + 1] for i, name in enumerate(BODYMASK_EDGE_CASES)})
        inputs["edge_all"] = edge
        err = 0
        for name, x in inputs.items():
            labels, mask = k1.bodymask_labels(x)
            ref_labels, ref_mask = k1.bodymask_labels_reference(x)
            torch.cuda.synchronize()
            e = max(
                int((labels - ref_labels).abs().max()),
                int((mask.int() - ref_mask.int()).abs().max()),
            )
            n_comp = int(torch.unique(ref_labels).numel()) - 1
            print(f"[kernel] {name} (B={x.shape[0]}): max_abs_err {e} over labels and masks, "
                  f"{n_comp} label values")
            self.check(e == 0, f"K1 differs from its plain version on {name}")
            err = max(err, e)
        x = inputs["phantom192"]
        med = _in_turns(torch, {"kernel": lambda: k1.bodymask_labels(x),
                                "plain": lambda: k1.bodymask_labels_reference(x)})
        pixels = x.numel()
        bound_ms, bound_by = _bound(pixels * (4 + 4 + 1), pixels)  # f32 in, int32 + u8 out
        edge_ms = _median_ms(torch, lambda: k1.bodymask_labels(edge))
        print(f"[kernel] B=192: K1 {med['kernel']:.4f} ms | plain torch {med['plain']:.4f} ms | "
              f"bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / med['kernel']:.1%} "
              f"(median of 10 CUDA-event runs of {REPS} launches each, in turns) | the 8 edge "
              f"slices {edge_ms:.4f} ms")
        self.state["k1"] = {"max_abs_err": err, "ms": med["kernel"], "plain_ms": med["plain"],
                            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}

    def unet(self):
        torch = self.torch
        from lungmask_tpu_torch.models import convert, synthetic, unet
        from lungmask_tpu_torch.transforms import preprocess

        dev = torch.device("cuda", 0)
        params = synthetic.laterality_params(wf=6)
        self.state["params"] = params
        x, _ = preprocess.preprocess_hybrid(self.state["phantom"][:32], device=dev)
        x = x.unsqueeze(-1)  # (32, 256, 256, 1) NHWC
        gpu32 = unet.UNet(convert.from_jax_params(params, dev), torch.float32).eval()
        cpu32 = unet.UNet(convert.from_jax_params(params), torch.float32).eval()
        gpu16 = unet.UNet(convert.from_jax_params(params, dev), torch.bfloat16).eval()
        # The crafted weights zero the decoder's projections, so only random
        # weights carry K2's and K3's outputs (GPU) and their plain versions
        # (CPU) into the logits.
        rnd = _random_params(0)
        rnd32 = unet.UNet(convert.from_jax_params(rnd, dev), torch.float32).eval()
        rnd32_cpu = unet.UNet(convert.from_jax_params(rnd), torch.float32).eval()
        with torch.inference_mode():
            lg = gpu32(x[:2]).cpu()
            lc = cpu32(x[:2].cpu())
            diff = (lg - lc).abs()
            bound = UNET_LOGIT_ATOL + UNET_LOGIT_RTOL * lc.abs()
            same_argmax = torch.equal(lg.argmax(-1), lc.argmax(-1))
            print(f"[unet] 2 slices GPU f32 (TF32 off) vs CPU f32, crafted weights: max "
                  f"|dlogit| {float(diff.max()):.3e} (bound {UNET_LOGIT_ATOL} + "
                  f"{UNET_LOGIT_RTOL}*|x|), identical argmax {same_argmax}")
            self.check(bool((diff <= bound).all()), "GPU f32 logits outside the bound")
            self.check(same_argmax, "GPU f32 argmax differs from CPU f32")
            rg = rnd32(x[:2]).cpu()
            rc = rnd32_cpu(x[:2].cpu())
            rdiff = (rg - rc).abs()
            agree_r = float((rg.argmax(-1) == rc.argmax(-1)).float().mean())
            print(f"[unet] 2 slices GPU f32 (K2, K3) vs CPU f32 (plain versions), random "
                  f"weights: max |dlogit| {float(rdiff.max()):.3e} of max |logit| "
                  f"{float(rc.abs().max()):.3e}, argmax agreement {agree_r:.6f}, "
                  f"classes {sorted(int(c) for c in torch.unique(rc.argmax(-1)))}")
            self.check(bool((rdiff <= UNET_LOGIT_ATOL + UNET_LOGIT_RTOL * rc.abs()).all()),
                       "GPU f32 logits of the random weights outside the bound")
            a32 = unet.unet_argmax(gpu32, x)
            a16 = unet.unet_argmax(gpu16, x)
            agree = float((a32 == a16).float().mean())
            classes = sorted(int(c) for c in torch.unique(a32))
            ms16 = _median_ms(torch, lambda: unet.unet_argmax(gpu16, x), 5, reps=1)
            ms32 = _median_ms(torch, lambda: unet.unet_argmax(gpu32, x), 5, reps=1)
        print(f"[unet] 32 slices 256²: bf16 argmax agreement with f32 {agree:.6f}, "
              f"classes {classes}")
        print(f"[unet] forward+argmax, batch 32: bf16 {ms16:.3f} ms "
              f"({32e3 / ms16:.1f} slices/s) | f32 {ms32:.3f} ms ({32e3 / ms32:.1f} slices/s)")
        self.check(agree >= BF16_MIN_AGREEMENT, f"bf16 agreement {agree} < {BF16_MIN_AGREEMENT}")
        self.check(classes == [0, 1, 2], f"expected classes 0-2, got {classes}")

    def stencil(self):
        import torch.nn.functional as F

        torch = self.torch
        from lungmask_tpu_torch.ops.kernels import stencil as st

        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(0)
        ops = {  # name: (wrapper, plain version, library op on the channels_last view,
                 #        float32 operations per output element)
            "avg_pool2": (st.avg_pool2, st.avg_pool2_reference, "F.avg_pool2d",
                          lambda x: F.avg_pool2d(x.permute(0, 3, 1, 2), 2), 4),
            # 18 per input element: two row-pass values of 3 operations each,
            # then 4 outputs of 3 each.
            "bilinear_up2": (st.bilinear_up2, st.bilinear_up2_reference, "F.interpolate",
                             lambda x: F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                                                     mode="bilinear", align_corners=False),
                             18 / 4),
        }
        pool96 = [(2, 96, 96, 64), (2, 48, 48, 128), (2, 24, 24, 256), (2, 12, 12, 512)]
        cases = [("avg_pool2", s) for s in POOL_SHAPES] + [("bilinear_up2", s) for s in UP_SHAPES]
        cases += [(name, s) for s in ODD_SHAPES for name in ops]
        cases += [("bilinear_up2", s) for s in TILE_SHAPES + VOLUME96_SHAPES]
        cases += [("avg_pool2", s) for s in pool96]
        errs = {name: 0.0 for name in ops}
        sums = {name: {"kernel": 0.0, "plain": 0.0, "library": 0.0, "bound": 0.0} for name in ops}
        bound_by = {name: set() for name in ops}
        for name, shape in cases:
            kern, plain, lib_name, lib, ops_per_out = ops[name]
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(shape, generator=gen, device=dev).to(dtype)
                got, want = kern(x), plain(x)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                same = torch.equal(got.view(bits), want.view(bits))
                errs[name] = max(errs[name], err)
                dt = str(dtype).split(".")[-1]
                if not (dtype == torch.bfloat16 and shape[0] == CHUNK):
                    print(f"[stencil] {name} {shape} {dt}: max_abs_err {err} bit-equal {same}")
                    self.check(same, f"{name} differs from its plain version at {shape} {dt}")
                    continue
                med = _in_turns(torch, {"kernel": lambda: kern(x), "plain": lambda: plain(x),
                                        "library": lambda: lib(x)})
                bound_ms, by = _bound((x.numel() + got.numel()) * x.element_size(),
                                      got.numel() * ops_per_out)
                bound_by[name].add(by)
                for k in med:
                    sums[name][k] += med[k]
                sums[name]["bound"] += bound_ms
                slower = [k for k in ("plain", "library") if med["kernel"] > med[k]]
                note = (f" | SLOWER than {' and '.join(slower)}; the kernel stays"
                        if slower else "")
                print(f"[stencil] {name} {shape} {dt}: max_abs_err {err} bit-equal {same} | "
                      f"kernel {med['kernel']:.4f} ms | bound {bound_ms:.4f} ms ({by}), "
                      f"share {bound_ms / med['kernel']:.1%} | plain {med['plain']:.4f} ms | "
                      f"{lib_name} {med['library']:.4f} ms{note}")
                self.check(same, f"{name} differs from its plain version at {shape} {dt}")
        for name in ops:
            t = sums[name]
            print(f"[stencil] {name} per 32-slice bf16 chunk (sum of the U-Net's 4 shapes): "
                  f"kernel {t['kernel']:.4f} ms | bound {t['bound']:.4f} ms "
                  f"({'+'.join(sorted(bound_by[name]))}), share "
                  f"{t['bound'] / t['kernel']:.1%} | plain {t['plain']:.4f} ms | "
                  f"{ops[name][2]} {t['library']:.4f} ms (medians of 10 CUDA-event runs of "
                  f"{REPS} launches each, in turns)")
        self.state["stencil"] = {
            name: {"max_abs_err": errs[name], "ms": sums[name]["kernel"],
                   "plain_ms": sums[name]["plain"], "bound_ms": sums[name]["bound"],
                   "bound_by": "+".join(sorted(bound_by[name])),
                   "library_ms": sums[name]["library"]}
            for name in ops
        }

    def fused(self):
        import numpy as np

        from lungmask_tpu_torch import LMInferer
        from lungmask_tpu_torch.io import image, loader
        from lungmask_tpu_torch.models import convert, registry, synthetic
        from lungmask_tpu_torch.ops import native

        tmp = self.state["tmp"]
        cache = os.path.join(tmp, "cache")
        os.makedirs(cache, exist_ok=True)
        for name, params in (
            ("LTRCLobes", synthetic.laterality_params(n_classes=6, wf=6)),
            ("R231", synthetic.threshold_params(wf=6)),
        ):
            stem = os.path.splitext(os.path.basename(registry.MODEL_URLS[name][0]))[0]
            convert.save_npz(os.path.join(cache, stem + ".npz"), params)
        os.environ["LUNGMASK_TPU_CACHE"] = cache
        self.state["cache"] = cache
        vol = self.state["phantom"]
        inferer = LMInferer(modelname="LTRCLobes", fillmodel="R231", tqdm_disable=True)
        self.check(inferer.device.type == "cuda" and inferer.fillmodelm.device == inferer.device,
                   f"fused inferer on {inferer.device}")
        masks = []
        _reset_launches()
        for call in range(2):
            inferer.timings.reset()
            t0 = time.perf_counter()
            masks.append(inferer.apply(vol))
            wall = time.perf_counter() - t0
            st = inferer.timings.summary()
            stages = " ".join(
                f"{k} {st.get(k, 0.0):.4f}"
                for k in ("preprocess", "unet", "postprocess", "paste_back", "fusion_postprocess")
            )
            print(f"[fused] call {call + 1}: {wall:.4f} s, {vol.shape[0] / wall:.2f} slices/s "
                  f"| stage s: {stages} (postprocess and paste_back summed over both models, "
                  f"which may overlap on two threads)")
        launches = _launches()
        self.state["fused_launches"] = launches
        m = masks[0]
        labels = sorted(int(v) for v in np.unique(m))
        print(f"[fused] launches in the 2 fused calls: {launches} | labels {labels} | "
              f"foreground share {float((m > 0).mean()):.4f} | shape {m.shape} {m.dtype}")
        self.check(np.array_equal(m, masks[1]), "the 2 fused masks differ")
        self.state["fused_mask"] = m
        self.check(bool(m.any()), "the fused mask is empty")
        self.check(set(labels) <= set(range(6)), f"labels {labels}")
        want = {"bodymask_labels": 2, "avg_pool2": 96, "bilinear_up2": 96}
        self.check(launches == want, f"launches {launches}, expected {want} (6 chunks x 4 x 2 "
                                     "models of K2 and K3, one K1 per call)")
        base = LMInferer(modelname="LTRCLobes", tqdm_disable=True).apply(vol)
        fill = LMInferer(modelname="R231", tqdm_disable=True).apply(vol)
        ref = native.fused_finish(base, fill)
        same = ref is not None and np.array_equal(m, ref)
        print(f"[fused] mask equals native.fused_finish of the two single-model masks: {same} "
              f"(base labels {sorted(int(v) for v in np.unique(base))}, fill labels "
              f"{sorted(int(v) for v in np.unique(fill))})")
        self.check(same, "the fused mask differs from fused_finish of the single-model masks")

        src = os.path.join(tmp, "fused_in.nii.gz")
        dst = os.path.join(tmp, "fused_out.nii.gz")
        loader.write_image(image.MedicalImage(vol[:64], spacing=(0.7, 0.7, 2.5)), src)
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "lungmask_tpu_torch", src, dst,
             "--modelname", "LTRCLobes_R231", "--noprogress"],
            capture_output=True, text=True, cwd=REPO, env=env, timeout=600,
        )
        wall = time.perf_counter() - t0
        print(f"[fused] CLI --modelname LTRCLobes_R231: rc {res.returncode} in {wall:.2f} s "
              f"(process start, build check, 64 slices)")
        self.check(res.returncode == 0, f"CLI failed:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        got = loader.load_input_image(dst).array
        same = bool(np.array_equal(got, inferer.apply(loader.load_input_image(src))))
        print(f"[fused] CLI mask read back equals the fused apply voxel for voxel: {same}")
        self.check(same, "fused CLI mask differs from the fused LMInferer.apply")

    def inferer(self):
        import numpy as np

        from lungmask_tpu_torch import LMInferer
        from lungmask_tpu_torch.models import convert

        vol = self.state["phantom"]
        wpath = os.path.join(self.state["tmp"], "laterality_wf6.npz")
        convert.save_npz(wpath, self.state["params"])
        self.state["weights"] = wpath
        inferer = LMInferer(modelpath=wpath, tqdm_disable=True)
        self.state["inferer"] = inferer
        self.check(inferer.device.type == "cuda", f"inferer on {inferer.device}")
        masks = []
        _reset_launches()
        for call in range(3):
            inferer.timings.reset()
            t0 = time.perf_counter()
            masks.append(inferer.apply(vol))
            wall = time.perf_counter() - t0
            st = inferer.timings.summary()
            stages = " ".join(
                f"{k} {st.get(k, 0.0):.4f}" for k in ("preprocess", "unet", "postprocess", "paste_back")
            )
            note = " (includes cuDNN warm-up)" if call == 0 else ""
            print(f"[inferer] call {call + 1}: {wall:.4f} s, {vol.shape[0] / wall:.2f} slices/s"
                  f"{note} | stage s: {stages}")
        launches = _launches()
        self.state["launches"] = launches
        h, w = vol.shape[1:]
        yy, xx = np.mgrid[0:h, 0:w]
        lung_l = ((yy - h / 2) / (h * 0.2)) ** 2 + ((xx - w * 0.35) / (w * 0.12)) ** 2 < 1
        lung_r = ((yy - h / 2) / (h * 0.2)) ** 2 + ((xx - w * 0.65) / (w * 0.12)) ** 2 < 1
        m = masks[0]
        left = float((m[:, lung_l] == 2).mean())
        right = float((m[:, lung_r] == 1).mean())
        labels = sorted(int(v) for v in np.unique(m))
        print(f"[inferer] launches on the main path (3 calls): {launches} | labels {labels} | "
              f"left lung -> 2: {left:.4f} | right lung -> 1: {right:.4f} | "
              f"shape {m.shape} {m.dtype}")
        self.check(all(np.array_equal(m, o) for o in masks[1:]), "the 3 masks differ")
        self.check(set(labels) <= {0, 1, 2}, f"labels {labels}")
        self.check(left >= LUNG_MIN_FRACTION and right >= LUNG_MIN_FRACTION, "lung fractions")
        want = {"bodymask_labels": 3, "avg_pool2": 72, "bilinear_up2": 72}
        self.check(launches == want, f"launches {launches}, expected {want} (per call one K1 "
                                     "and 6 chunks x 4 of K2 and K3)")

        # Slices under 128² take the strict host preprocessing; the U-Net
        # still runs on the card.
        from lungmask_tpu_torch.models.synthetic import lung_phantom

        small = lung_phantom(40, size=96)
        _reset_launches()
        pre = inferer.preprocess_image(small)
        small_mask = inferer.apply_preprocessed(pre)
        small_launches = _launches()
        lungs = sorted(int(v) for v in np.unique(small_mask))
        print(f"[inferer] 40x96² volume (host preprocessing): stack on {pre['normalized'].device}, "
              f"launches {small_launches}, labels {lungs}, shape {small_mask.shape}")
        self.check(pre["normalized"].is_cuda, "the small volume's stack is not on the card")
        self.check(small_launches == {"bodymask_labels": 0, "avg_pool2": 8, "bilinear_up2": 8},
                   f"small-volume launches {small_launches}")
        self.check(small_mask.shape == small.shape and lungs == [0, 1, 2], f"labels {lungs}")

    def cli(self):
        import numpy as np

        from lungmask_tpu_torch.io import image, loader

        src = os.path.join(self.state["tmp"], "in.nii.gz")
        dst = os.path.join(self.state["tmp"], "out.nii.gz")
        img = image.MedicalImage(self.state["phantom"][:64], spacing=(0.7, 0.7, 2.5))
        loader.write_image(img, src)
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "lungmask_tpu_torch", src, dst,
             "--modelpath", self.state["weights"], "--noprogress"],
            capture_output=True, text=True, cwd=REPO, env=env, timeout=600,
        )
        wall = time.perf_counter() - t0
        print(f"[cli] rc {res.returncode} in {wall:.2f} s (process start, build check, 64 slices)")
        self.check(res.returncode == 0, f"CLI failed:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        got = loader.load_input_image(dst).array
        want = self.state["inferer"].apply(loader.load_input_image(src))
        same = bool(np.array_equal(got, want))
        print(f"[cli] mask read back equals LMInferer.apply voxel for voxel: {same}")
        self.check(same, "CLI mask differs from LMInferer.apply")

    def postdev(self):
        import numpy as np

        torch = self.torch
        from lungmask_tpu_torch import LMInferer
        from lungmask_tpu_torch.metrics import compare_masks
        from lungmask_tpu_torch.transforms.postprocess_device import postprocess_device

        vol = self.state["phantom"]
        exact_inf = self.state["inferer"]
        inferer = LMInferer(modelpath=self.state["weights"], tqdm_disable=True,
                            postprocessing_mode="device")
        self.check(inferer.device.type == "cuda", f"device-mode inferer on {inferer.device}")
        masks = []
        _reset_launches()
        for call in range(2):
            inferer.timings.reset()
            t0 = time.perf_counter()
            masks.append(inferer.apply(vol))
            wall = time.perf_counter() - t0
            st = inferer.timings.summary()
            stages = " ".join(f"{k} {st.get(k, 0.0):.4f}"
                              for k in ("preprocess", "unet", "postprocess", "paste_back"))
            print(f"[postdev] device-mode apply {call + 1}: {wall:.4f} s | stage s: {stages}")
        launches = _launches()
        exact_inf.timings.reset()
        t0 = time.perf_counter()
        exact = exact_inf.apply(vol)
        wall = time.perf_counter() - t0
        print(f"[postdev] exact-mode apply: {wall:.4f} s | postprocess "
              f"{exact_inf.timings.summary()['postprocess']:.4f} s")
        m = masks[0]
        labels = sorted(int(v) for v in np.unique(m))
        self.check(np.array_equal(m, masks[1]), "the 2 device-mode masks differ")
        self.check(m.shape == vol.shape and m.dtype == np.uint8, f"mask {m.shape} {m.dtype}")
        self.check(set(labels) <= {0, 1, 2} and m.any(), f"device-mode labels {labels}")
        self.check(all(v > 0 for v in launches.values()), f"launches {launches}")
        cmp = compare_masks(m, exact)
        print(f"[postdev] launches in the 2 device-mode calls: {launches} | labels {labels} | "
              f"device vs exact: voxel agreement {cmp.voxel_accuracy:.6f}, macro Dice "
              f"{cmp.macro_dice:.6f} (divergence contract, not gated)")

        # One class map made on the card, cleaned on the card and on the CPU.
        pred = inferer.forward_preprocessed(inferer.preprocess_image(vol))
        self.check(pred.is_cuda, f"the device-mode class map lies on {pred.device}")
        gpu_stats, cpu_stats = {}, {}
        postprocess_device(pred, 3)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu = postprocess_device(pred, 3, gpu_stats)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        self.check(gpu.is_cuda, f"the device cleanup ran on {gpu.device}")
        t0 = time.perf_counter()
        cpu = postprocess_device(pred.cpu(), 3, cpu_stats)
        t_cpu = time.perf_counter() - t0
        same = torch.equal(gpu.cpu(), cpu)
        print(f"[postdev] cleanup of one {tuple(pred.shape)} class map: GPU {t_gpu:.4f} s "
              f"(rounds: label {gpu_stats['label_rounds']}, fill {gpu_stats['fill_rounds']}) | "
              f"CPU {t_cpu:.4f} s (label {cpu_stats['label_rounds']}, fill "
              f"{cpu_stats['fill_rounds']}) | bit-equal {same}")
        self.check(same, "the GPU cleanup differs from the CPU cleanup of the same map")
        self.state["dev_inferer"] = inferer

        fused = LMInferer(modelname="LTRCLobes", fillmodel="R231", tqdm_disable=True,
                          postprocessing_mode="device")
        self.check(not fused._fused_finish_threads(), "device-mode fused finishes on 2 threads")
        fmasks = []
        for call in range(2):
            fused.timings.reset()
            t0 = time.perf_counter()
            fmasks.append(fused.apply(vol))
            wall = time.perf_counter() - t0
            st = fused.timings.summary()
            stages = " ".join(f"{k} {st.get(k, 0.0):.4f}" for k in (
                "preprocess", "unet", "postprocess", "paste_back", "fusion_postprocess"))
            print(f"[postdev] fused device-mode apply {call + 1}: {wall:.4f} s | stage s: {stages}")
        f = fmasks[0]
        self.check(np.array_equal(f, fmasks[1]), "the 2 fused device-mode masks differ")
        self.check(set(int(v) for v in np.unique(f)) <= set(range(6)), "fused labels")
        fcmp = compare_masks(f, self.state["fused_mask"], n_classes=6)
        print(f"[postdev] fused device vs exact: voxel agreement {fcmp.voxel_accuracy:.6f}, "
              f"macro Dice {fcmp.macro_dice:.6f} | labels "
              f"{sorted(int(v) for v in np.unique(f))}")

    def _write_volumes(self, counts, stem):
        from lungmask_tpu_torch.io import image, loader

        paths = []
        for i, n in enumerate(counts):
            path = os.path.join(self.state["tmp"], f"{stem}{i}.nii")
            img = image.MedicalImage(self.state["phantom"][:n], spacing=(0.7, 0.7, 2.5))
            loader.write_image(img, path)
            paths.append(path)
        return paths

    def cohort(self):
        import numpy as np

        from lungmask_tpu_torch.io import loader
        from lungmask_tpu_torch.runtime.cohort import run_cohort

        paths = self._write_volumes(COHORT_SLICES, "cohort")
        chunks = sum(-(-n // CHUNK) for n in COHORT_SLICES)
        want = {"bodymask_labels": len(paths), "avg_pool2": 4 * chunks, "bilinear_up2": 4 * chunks}
        for mode, inferer in (("exact", self.state["inferer"]),
                              ("device", self.state["dev_inferer"])):
            out = os.path.join(self.state["tmp"], f"cohort_{mode}")
            os.makedirs(out)
            _reset_launches()
            stats = run_cohort(paths, inferer, output_dir=out)
            launches = _launches()
            errors = [r.error for r in stats.results if r.error]
            print(f"[cohort] {mode}: {len(paths)} volumes ({'+'.join(map(str, COHORT_SLICES))} "
                  f"slices of 512²) in {stats.wall_seconds:.4f} s = "
                  f"{stats.volumes_per_hour:.1f} volumes/h | stage s {stats.stage_seconds} | "
                  f"launches {launches}")
            self.check(not errors and len(stats.results) == len(paths), f"errors {errors}")
            self.check(launches == want, f"launches {launches}, expected {want}")
            for r, path in zip(stats.results, paths):
                got = loader.load_input_image(os.path.join(out, f"{r.name}_mask.nii.gz")).array
                ref = inferer.apply(loader.load_input_image(path))
                self.check(np.array_equal(got, ref), f"{mode} cohort mask {r.name} differs "
                                                     "from apply")
            print(f"[cohort] {mode}: every written mask equals apply's")

    def serve(self):
        import threading
        import urllib.request

        import numpy as np

        from lungmask_tpu_torch.io import loader
        from lungmask_tpu_torch.runtime.serve import make_server

        inferer = self.state["inferer"]
        paths = self._write_volumes(SERVE_SLICES, "serve")
        uploads = []
        for path in paths:
            with open(path, "rb") as fh:
                uploads.append(fh.read())
        httpd, service = make_server(inferer, port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            print(f"[serve] /healthz {health}")
            self.check(health["backend"] == "cuda", f"backend {health['backend']}")
            results = [None] * len(uploads)
            todo = list(range(len(uploads)))
            lock = threading.Lock()

            def client():
                while True:
                    with lock:
                        if not todo:
                            return
                        i = todo.pop(0)
                    req = urllib.request.Request(
                        base + "/v1/segment?name=v.nii&out=.nii.gz", data=uploads[i],
                        method="POST",
                    )
                    with urllib.request.urlopen(req, timeout=300) as r:
                        results[i] = (r.status, r.read())

            _reset_launches()
            t0 = time.perf_counter()
            clients = [threading.Thread(target=client) for _ in range(2)]
            for c in clients:
                c.start()
            for c in clients:
                c.join()
            wall = time.perf_counter() - t0
            launches = _launches()
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join()
        metrics = service.metrics()
        print(f"[serve] {len(uploads)} uploads from 2 clients in {wall:.4f} s = "
              f"{3600 * len(uploads) / wall:.1f} volumes/h | launches {launches} | service "
              f"s: " + " ".join(f"{k} {v:.4f}" for k, v in metrics.items()
                                if k.endswith("seconds")))
        self.check(all(r is not None and r[0] == 200 for r in results), "a request failed")
        self.check(all(v > 0 for v in launches.values()), f"launches {launches}")
        for (status, body), path in zip(results, paths):
            got = loader.load_input_bytes(bytearray(body), "m.nii.gz").array
            ref = inferer.apply(loader.load_input_image(path))
            self.check(np.array_equal(got, ref), f"the response for {path} differs from apply")
        print("[serve] every response equals apply's")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import lungmask_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    smoke = Smoke(torch)
    with tempfile.TemporaryDirectory(prefix="lungmask_smoke_") as tmp:
        smoke.state["tmp"] = tmp
        # What each phase needs from an earlier one: state key → its maker.
        needs = {
            "unet": {"phantom": "kernel"},
            "fused": {"phantom": "kernel"},
            "inferer": {"phantom": "kernel", "params": "unet"},
            "cli": {"phantom": "kernel", "params": "unet", "inferer": "inferer"},
            "postdev": {"phantom": "kernel", "inferer": "inferer", "fused_mask": "fused"},
            "cohort": {"phantom": "kernel", "inferer": "inferer", "dev_inferer": "postdev"},
            "serve": {"phantom": "kernel", "inferer": "inferer"},
        }
        for name in ("device", "build", "kernel", "unet", "stencil", "fused", "inferer", "cli",
                     "postdev", "cohort", "serve"):
            missing = [(key, maker) for key, maker in needs.get(name, {}).items()
                       if key not in smoke.state]
            if missing:
                smoke.failures.append(name)
                key, maker = missing[0]
                print(f"[{name}] FAILED: skipped, the {maker} phase made no {key}")
                continue
            smoke.phase(name, getattr(smoke, name))
    if smoke.failures:
        print(f"chip_smoke: FAILED phases: {', '.join(smoke.failures)}")
        return 1
    measured = {"bodymask_labels": smoke.state["k1"], **smoke.state["stencil"]}
    sources = {
        "bodymask_labels": (K1_SOURCE, K1_REPLACES),
        "avg_pool2": (STENCIL_SOURCE, K2_REPLACES),
        "bilinear_up2": (STENCIL_SOURCE, K3_REPLACES),
    }
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": smoke.state["launches"][name],
        **{key: measured[name][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    } for name, (source, replaces) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
