#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lungmask_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel of the main path from the sources in this checkout,
checks each against its plain PyTorch version on the card, then drives the
main path — ``LMInferer(...).apply`` and the ``lungmask-torch INPUT OUTPUT``
CLI with their defaults (hybrid preprocessing, bf16 U-Net, exact host
postprocessing) — at the production width (R231 U-Net, wf=6) with the
crafted laterality weights on a 192-slice 512² lung phantom made from a seed.

Phases: device, build, kernel, unet, inferer, cli; each prints its results
on its own lines. The second-to-last line is a JSON object describing the
kernels; the last line is ``{"ok": true, "device": {...}}`` and is printed
only when every phase passed. Exits non-zero, printing no result, when no
CUDA device is available or any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

K1_SOURCE = "lungmask_tpu_torch/csrc/bodymask.cu"
K1_REPLACES = "lungmask_tpu/ops/pallas/bodymask.py:136"
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

        t0 = time.perf_counter()
        k1.build()
        t1 = time.perf_counter()
        loaded = native.native_loaded()
        t2 = time.perf_counter()
        print(f"[build] K1 nvcc {t1 - t0:.2f} s | host core g++ {t2 - t1:.2f} s")
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
        with torch.inference_mode():
            lg = gpu32(x[:2]).cpu()
            lc = cpu32(x[:2].cpu())
            diff = (lg - lc).abs()
            bound = UNET_LOGIT_ATOL + UNET_LOGIT_RTOL * lc.abs()
            same_argmax = torch.equal(lg.argmax(-1), lc.argmax(-1))
            print(f"[unet] 2 slices GPU f32 (TF32 off) vs CPU f32: max |dlogit| "
                  f"{float(diff.max()):.3e} (bound {UNET_LOGIT_ATOL} + {UNET_LOGIT_RTOL}*|x|), "
                  f"identical argmax {same_argmax}")
            self.check(bool((diff <= bound).all()), "GPU f32 logits outside the bound")
            self.check(same_argmax, "GPU f32 argmax differs from CPU f32")
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

    def inferer(self):
        import numpy as np

        from lungmask_tpu_torch import LMInferer
        from lungmask_tpu_torch.models import convert
        from lungmask_tpu_torch.ops.kernels import bodymask as k1

        vol = self.state["phantom"]
        wpath = os.path.join(self.state["tmp"], "laterality_wf6.npz")
        convert.save_npz(wpath, self.state["params"])
        self.state["weights"] = wpath
        inferer = LMInferer(modelpath=wpath, tqdm_disable=True)
        self.state["inferer"] = inferer
        self.check(inferer.device.type == "cuda", f"inferer on {inferer.device}")
        masks = []
        k1.bodymask_labels.launches = 0
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
        launches = k1.bodymask_labels.launches
        self.state["launches"] = launches
        h, w = vol.shape[1:]
        yy, xx = np.mgrid[0:h, 0:w]
        lung_l = ((yy - h / 2) / (h * 0.2)) ** 2 + ((xx - w * 0.35) / (w * 0.12)) ** 2 < 1
        lung_r = ((yy - h / 2) / (h * 0.2)) ** 2 + ((xx - w * 0.65) / (w * 0.12)) ** 2 < 1
        m = masks[0]
        left = float((m[:, lung_l] == 2).mean())
        right = float((m[:, lung_r] == 1).mean())
        labels = sorted(int(v) for v in np.unique(m))
        print(f"[inferer] K1 launches on the main path: {launches} | labels {labels} | "
              f"left lung -> 2: {left:.4f} | right lung -> 1: {right:.4f} | "
              f"shape {m.shape} {m.dtype}")
        self.check(all(np.array_equal(m, o) for o in masks[1:]), "the 3 masks differ")
        self.check(set(labels) <= {0, 1, 2}, f"labels {labels}")
        self.check(left >= LUNG_MIN_FRACTION and right >= LUNG_MIN_FRACTION, "lung fractions")
        self.check(launches == 3, f"K1 launched {launches} times in 3 applies")

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
        for name in ("device", "build", "kernel", "unet", "inferer", "cli"):
            if name in ("unet", "inferer", "cli") and "phantom" not in smoke.state:
                smoke.failures.append(name)
                print(f"[{name}] FAILED: skipped, the kernel phase made no phantom")
                continue
            if name in ("inferer", "cli") and "params" not in smoke.state:
                smoke.failures.append(name)
                print(f"[{name}] FAILED: skipped, the unet phase made no weights")
                continue
            if name == "cli" and "inferer" not in smoke.state:
                smoke.failures.append(name)
                print(f"[{name}] FAILED: skipped, the inferer phase made no inferer")
                continue
            smoke.phase(name, getattr(smoke, name))
    if smoke.failures:
        print(f"chip_smoke: FAILED phases: {', '.join(smoke.failures)}")
        return 1
    k1 = smoke.state["k1"]
    print(json.dumps({"kernels": [{
        "name": "bodymask_labels",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": smoke.state["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
