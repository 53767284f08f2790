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
  host postprocessing).

Each path's apply calls run with every kernel's launch count set to 0 just
before them and read just after.

Phases: device, build, kernel, unet, stencil, fused, inferer, cli; each
prints its results on its own lines. The second-to-last line is a JSON
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
UNET_LOGIT_ATOL, UNET_LOGIT_RTOL = 1e-3, 1e-4  # GPU f32 (TF32 off) vs CPU f32
BF16_MIN_AGREEMENT = 0.98  # GPU bf16 argmax vs GPU f32, a gross check
LUNG_MIN_FRACTION = 0.95  # share of each phantom lung given its class


def _times_ms(torch, fn, runs: int) -> list:
    """``runs`` timings of ``fn`` in ms with CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _median_ms(torch, fn, runs: int = 10) -> float:
    import numpy as np

    return float(np.median(_times_ms(torch, fn, runs)))


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
        self.check(loaded, "the native host core did not build or load")

    def kernel(self):
        import numpy as np

        torch = self.torch
        from lungmask_tpu_torch.models.synthetic import lung_phantom
        from lungmask_tpu_torch.ops.kernels import bodymask as k1
        from lungmask_tpu_torch.transforms import preprocess

        dev = torch.device("cuda", 0)
        vol = lung_phantom(192)
        self.state["phantom"] = vol
        packed = torch.from_numpy(preprocess.pack_bodymask_bits(vol)).to(dev)
        inputs = {
            "phantom192": preprocess.smalls_from_packed(packed).float(),
            "random64": torch.from_numpy(_random_slices(1, 64)).to(dev),
        }
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
            print(f"[kernel] {name}: max_abs_err {e} over labels and masks, "
                  f"{n_comp} label values")
            self.check(e == 0, f"K1 differs from its plain version on {name}")
            err = max(err, e)
        x = inputs["phantom192"]
        # Turns of plain, kernel, kernel, plain, 5 runs each: the median of 10.
        plain = _times_ms(torch, lambda: k1.bodymask_labels_reference(x), 5)
        kern = _times_ms(torch, lambda: k1.bodymask_labels(x), 5)
        kern += _times_ms(torch, lambda: k1.bodymask_labels(x), 5)
        plain += _times_ms(torch, lambda: k1.bodymask_labels_reference(x), 5)
        ms, plain_ms = float(np.median(kern)), float(np.median(plain))
        print(f"[kernel] B=192: K1 {ms:.4f} ms | plain torch {plain_ms:.4f} ms "
              f"(median of 10 CUDA-event runs each, in turns)")
        self.state["k1"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

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
            ms16 = _median_ms(torch, lambda: unet.unet_argmax(gpu16, x), 5)
            ms32 = _median_ms(torch, lambda: unet.unet_argmax(gpu32, x), 5)
        print(f"[unet] 32 slices 256²: bf16 argmax agreement with f32 {agree:.6f}, "
              f"classes {classes}")
        print(f"[unet] forward+argmax, batch 32: bf16 {ms16:.3f} ms "
              f"({32e3 / ms16:.1f} slices/s) | f32 {ms32:.3f} ms ({32e3 / ms32:.1f} slices/s)")
        self.check(agree >= BF16_MIN_AGREEMENT, f"bf16 agreement {agree} < {BF16_MIN_AGREEMENT}")
        self.check(classes == [0, 1, 2], f"expected classes 0-2, got {classes}")

    def stencil(self):
        import numpy as np
        import torch.nn.functional as F

        torch = self.torch
        from lungmask_tpu_torch.ops.kernels import stencil as st

        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(0)
        ops = {  # name: (wrapper, plain version, library op on the channels_last view)
            "avg_pool2": (st.avg_pool2, st.avg_pool2_reference, "F.avg_pool2d",
                          lambda x: F.avg_pool2d(x.permute(0, 3, 1, 2), 2)),
            "bilinear_up2": (st.bilinear_up2, st.bilinear_up2_reference, "F.interpolate",
                             lambda x: F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                                                     mode="bilinear", align_corners=False)),
        }
        cases = [("avg_pool2", s) for s in POOL_SHAPES] + [("bilinear_up2", s) for s in UP_SHAPES]
        cases += [(name, s) for s in ODD_SHAPES for name in ops]
        cases.append(("bilinear_up2", (1, 1, 3, 5)))  # one row: both clamps meet
        errs = {name: 0.0 for name in ops}
        sums = {name: {"kernel": 0.0, "plain": 0.0, "library": 0.0} for name in ops}
        for name, shape in cases:
            kern, plain, lib_name, lib = ops[name]
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
                # Median of 10 CUDA-event runs each, in turns: 5 runs of each
                # in one order, then 5 in the reverse order.
                fns = {"kernel": lambda: kern(x), "plain": lambda: plain(x),
                       "library": lambda: lib(x)}
                times = {k: [] for k in fns}
                for order in (("kernel", "plain", "library"), ("library", "plain", "kernel")):
                    for k in order:
                        times[k] += _times_ms(torch, fns[k], 5)
                med = {k: float(np.median(v)) for k, v in times.items()}
                for k in med:
                    sums[name][k] += med[k]
                nbytes = (x.numel() + got.numel()) * x.element_size()
                rate = nbytes / med["kernel"] / 1e6  # GB/s
                slower = [k for k in ("plain", "library") if med["kernel"] > med[k]]
                note = (f" | SLOWER than {' and '.join(slower)}; the kernel stays"
                        if slower else "")
                print(f"[stencil] {name} {shape} {dt}: max_abs_err {err} bit-equal {same} | "
                      f"kernel {med['kernel']:.4f} ms ({rate:.1f} GB/s, "
                      f"{100 * rate / 3350:.1f}% of 3.35 TB/s) | plain {med['plain']:.4f} ms | "
                      f"{lib_name} {med['library']:.4f} ms{note}")
                self.check(same, f"{name} differs from its plain version at {shape} {dt}")
        for name in ops:
            t = sums[name]
            print(f"[stencil] {name} per 32-slice bf16 chunk (sum of the U-Net's 4 shapes): "
                  f"kernel {t['kernel']:.4f} ms | plain {t['plain']:.4f} ms | "
                  f"{ops[name][2]} {t['library']:.4f} ms")
        self.state["stencil"] = {
            name: {"max_abs_err": errs[name], "ms": sums[name]["kernel"],
                   "plain_ms": sums[name]["plain"]}
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
        }
        for name in ("device", "build", "kernel", "unet", "stencil", "fused", "inferer", "cli"):
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
        "max_abs_err": measured[name]["max_abs_err"],
        "ms": measured[name]["ms"],
        "plain_ms": measured[name]["plain_ms"],
    } for name, (source, replaces) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
