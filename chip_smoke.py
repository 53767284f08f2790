#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lungmask_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel of the port from the sources in this checkout (K1, the
bodymask; K2 and K3, the U-Net's pooling and upsampling, and their adjoints
K2ᵀ and K3ᵀ; all nvcc builds started together), checks each against its
plain PyTorch version on the card, then drives the port's paths at the
production width (U-Net wf=6) on a 192-slice 512² lung phantom made from a
seed, with crafted weights:

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
* DICOM — the 192-slice phantom written as an uncompressed series by the
  port's writer, through ``load_input_image(SERIES_DIR)`` and ``apply`` and
  through the CLI to ``.nii.gz`` and to ``.dcm``, every mask equal to
  ``apply``'s on the same array (K1/K2/K3 launched 1/24/24); a 32-slice RLE
  series; one slice in each transfer syntax the port can encode without
  Pillow or CharLS, and the two committed JPEG 2000 / JPEG-LS fixtures
  (``tests/data/torch_port/``), each decoded bit-exactly (the lossy DCT
  syntaxes within 2); the codec core must be the native library built into
  ``lungmask_tpu_torch/_build/``;
* the cohort lane — ``run_cohort`` over four phantom NIfTI files and one
  DICOM series directory, exact and device mode, every mask equal to
  ``apply``'s;
* the serve lane — ``make_server`` in this process, three NIfTI uploads from
  two client threads and one zipped DICOM series answered with ``out=.dcm``,
  every response equal to ``apply``'s;
* device preprocessing — ``LMInferer(preprocessing="device").apply``, K1/K2/K3
  launched 1/24/24 times, its boxes equal to the hybrid mode's, its mask's
  agreement with the hybrid mask printed, ``apply`` timed in turns with the
  hybrid mode;
* fine-tuning — ``train.fit`` of a fresh wf=6 U-Net (``unet.init_params``,
  seed 0) in bf16 at batch 8 on 256² slices made on the card by
  ``slices_from_pair`` (phantom[:64] to train, phantom[64:96] to evaluate,
  the exact-path mask as labels): 16 steps, the loss must fall, each step
  launching K2/K3/K2ᵀ/K3ᵀ 4/4/4/4 times; a resume from the step-8
  checkpoint under ``cudnn.deterministic`` against the uninterrupted run;
  K2ᵀ and K3ᵀ bit-equal to their plain adjoints at the train step's shapes
  (the stencil phase holds K2 and K3 there too); train-step time, slices/s,
  peak memory and a profile of three steps; and the ``python -m
  lungmask_tpu_torch.train.finetune`` entry point on phantom NIfTI pairs,
  its weights applied by ``LMInferer``;
* the U-Net variants — ``residual``, ``upconv`` and both, at production
  width from seeded reference-layout state dicts
  (``synthetic.reference_state_dict``): on one 32-slice chunk, GPU f32
  logits of its first 8 slices against CPU f32, bf16 argmax against f32
  on all 32, K2/K3 launches per
  forward (4/4, 4/0 for upconv), and ``LMInferer(modelpath=<.pth>)`` on the
  192-slice phantom;
* the device mesh — ``LMInferer(mesh=)`` over ``make_mesh()`` (every card)
  and over a two-way data mesh on one card (``[cuda:0, cuda:0]``, batch 64:
  each shard runs the unsharded chunk's 32 slices), sharded preprocessing,
  exact and device postprocessing, single and fused, every mask equal to
  the unsharded ``preprocessing="device"`` inferer's;
  ``make_sharded_postprocess`` against ``postprocess_device`` on the card;
  ``fit(mesh=)`` next to the unsharded fit, one f32 step's loss and
  gradients against the plain loss at the shards' shapes (1e-5) and the
  unsharded step's, and one step through a
  one-process NCCL group (``parallel.multihost``);
* the mesh's space axis — height bands with halo rows: on one 32-slice
  chunk (crafted and random wf=6 weights) two bands' f32 logits within
  1e-4 of the largest |logit| of the whole height's with the same argmax,
  their bf16 argmax agreement printed (≥ 0.9999), K2/K3 launches per band;
  K2/K2ᵀ at the bands' shapes and K3/K3ᵀ at the padded bands' of every
  level, bit-equal to their plain versions; ``LMInferer(mesh=)`` over a 1x2
  (``[cuda:0] * 2, space=2``) and a 2x2 mesh on one card, single and fused,
  exact and device, its masks' differing voxels against the unsharded
  device-mode masks (0 with an f32 model), K1 1 per data slab and K2/K3 24
  per band per ``apply``; ``make_sharded_postprocess`` of the phantom's map
  on the 2x2 blocks, bit-equal; ``fit(mesh=1x2)`` beside the unsharded fit
  (losses within 1e-3), one f32 step (loss 1e-5, leaves 1e-3 of their
  largest) and the banded step's time.

Each path's calls run with every kernel's launch count set to 0 just before
them and read just after. The stencils' times at the U-Net's bf16 shapes
come in three readings: back to back, the CUDA-event median over runs of
20 calls of the wrapper (where the wrapper's host work per call is longer
than the kernel, this reads the host); the card's own time per launch, the
mean duration of the kernel's CUDA events in one ``torch.profiler`` window
over 20 calls per shape; and the host's µs per call, the wall time to make
200 calls. Each stands beside the kernel's bound: the larger of its bytes
over 3.35 TB/s and its operations over 67 TFLOP/s (float32, no tensor
cores), the H100 SXM's published peaks. An adjoint's library time is one
call of torch's own backward op for the same function
(``aten.avg_pool2d_backward``, ``aten.upsample_bilinear2d_backward``).
The kernels line gives K2 and K3 per 32-slice inference chunk and K2ᵀ and
K3ᵀ per train step of batch 8, each summed over the U-Net's four shapes.

Phases: device, build, kernel, unet, stencil, fused, inferer, cli, dicom,
postdev, cohort, serve, devprep, train, variants, mesh, space; each prints its
results on its own lines, and fails if it left torch's current CUDA device
changed (the launchers must restore the caller's device). The second-to-last line is a JSON
object describing the kernels; the last line is ``{"ok": true, "device":
{...}}`` and is printed only when every phase passed. Exits non-zero,
printing no result, when no CUDA device is available (2), when the port is
not beside the script (1: the script alone, outside a checkout) or when any
phase fails (1). Imports nothing of JAX.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import zipfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

K1_SOURCE = "lungmask_tpu_torch/csrc/bodymask.cu"
K1_REPLACES = "lungmask_tpu/ops/pallas/bodymask.py:136"
STENCIL_SOURCE = "lungmask_tpu_torch/csrc/stencil.cu"
K2_REPLACES = "lungmask_tpu/ops/pallas/stencil.py:58"
K3_REPLACES = "lungmask_tpu/ops/pallas/stencil.py:126"
# The JAX package has no backward kernel: K2ᵀ and K3ᵀ replace XLA's
# transposes of the U-Net's _avg_pool2 and _bilinear_up2.
K2T_REPLACES = "lungmask_tpu/models/unet.py:176"
K3T_REPLACES = "lungmask_tpu/models/unet.py:191"
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
# K3ᵀ's outputs that straddle its tiles: ragged row and column tiles and a
# short last channel slab.
ADJOINT_TILE_SHAPES = [(2, 19, 13, 264), (1, 10, 9, 520)]
VOLUME96_SHAPES = [(2, 6, 6, 1024), (2, 12, 12, 512), (2, 24, 24, 256), (2, 48, 48, 128)]
K1_BATCHES = (1, 192, 193)
FORWARD = ("bodymask_labels", "avg_pool2", "bilinear_up2")
BACKWARD = ("avg_pool2_bwd", "bilinear_up2_bwd")
TRAIN_BATCH = 8
# The same stencils in one train step (batch 8); K2ᵀ and K3ᵀ take the
# gradients of their outputs.
TRAIN_POOL_SHAPES = [(TRAIN_BATCH,) + s[1:] for s in POOL_SHAPES]
TRAIN_UP_SHAPES = [(TRAIN_BATCH,) + s[1:] for s in UP_SHAPES]
# The shapes whose bf16 times are summed: per inference chunk, per train step.
TIMED = {"chunk": POOL_SHAPES + UP_SHAPES, "step": TRAIN_POOL_SHAPES + TRAIN_UP_SHAPES}
TRAIN_SLICES, EVAL_SLICES = 64, 32  # phantom[:64] to train, phantom[64:96] to evaluate
TRAIN_EPOCHS = 2  # 16 steps
TRAIN_PEAK_LR = 1e-3  # a fresh net: default_optimizer's 1e-4 is a fine-tuning rate
RESUME_RTOL = 1e-3
# The U-Net variants: (residual, up_mode) of the reference-layout state dict.
VARIANTS = {"residual": (True, "upsample"), "upconv": (False, "upconv"),
            "residual+upconv": (True, "upconv")}
VARIANT_SEED = 0
# Slices of the chunk whose f32 logits are also computed on the CPU (the
# whole chunk took 12-20 s per variant on the card's host).
VARIANT_CPU_SLICES = 8
MESH_BATCH = 64  # the two-way mesh's chunk: 32 slices per shard, as unsharded
MESH_TRAIN_SLICES = 32  # fit(mesh=): 4 steps of batch 8 (4 per shard)
GRAD_RTOL = 1e-5  # one f32 train step, sharded vs unsharded (the CPU tests' bound)
GRAD_GROSS = 1e-2  # the same at other batch shapes (see _mesh_train)
# The space phase (1x2 and 2x2 meshes on one card, bands of 128 rows).
SPACE_LOGIT_RTOL = 1e-4  # banded f32 logits, of the largest |logit|
SPACE_BF16_AGREEMENT = 0.9999  # banded bf16 argmax against unbanded bf16
SPACE_VOXEL_SHARE = 1e-5  # bf16 masks: differing voxels, of the volume's
SPACE_LOSS_RTOL = 1e-3  # fit(mesh=1x2) bf16 losses against the unsharded fit's
SPACE_GRAD_RTOL = 1e-3  # one f32 step: each leaf, of its largest gradient
REPS = 20  # back-to-back launches per CUDA-event pair and per profiler group
HOST_CALLS = 200  # wrapper calls per reading of the host's cost
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
UNET_LOGIT_ATOL, UNET_LOGIT_RTOL = 1e-3, 1e-4  # GPU f32 (TF32 off) vs CPU f32
BF16_MIN_AGREEMENT = 0.98  # GPU bf16 argmax vs GPU f32, a gross check
LUNG_MIN_FRACTION = 0.95  # share of each phantom lung given its class
COHORT_SLICES = (192, 160, 128, 96)  # the four cohort volumes: phantom[:n]
SERVE_SLICES = (192, 128, 96)  # the three uploads
SERIES_SLICES = 64  # the DICOM series of the cohort and serve lanes
RLE_SLICES = 32
HTJ2K_CROP = 128  # the pure-Python HTJ2K encoder takes ~3 s per 512² slice
DCT_TOLERANCE = 2  # quant=1 DCT round trip, the bound of tests/test_codecs.py
# The committed fixtures the card's machine cannot encode (no Pillow or
# CharLS there): made by tests/test_torch_codecs.py from synthetic.codec_slice.
FIXTURE_DIR = "tests/data/torch_port"
FIXTURE_SEED = 5
KEPT_TAGS = {"0010|0010": "DOE^JANE", "0010|0020": "P0042", "0008|0020": "20260102",
             "0020|000d": "1.2.826.0.1.3680043.10.1464.3.1"}


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


def _device_ms(torch, groups: list, reps: int = REPS) -> list:
    """The card's own ms per launch of each ``(symbol, fn)`` of ``groups``:
    one ``torch.profiler`` window over ``reps`` back-to-back calls of each
    fn in turn (after a warm-up call), the groups parted on the card's
    timeline by a one-element ``fill_`` before each and after the last; the
    mean duration of the CUDA kernels between a group's two fills (the
    window's last ones) whose name holds ``symbol``. None, with a line
    saying so, where there are not ``reps`` of them."""
    import re

    from torch.profiler import ProfilerActivity, profile

    for _, fn in groups:
        fn()
    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # A window that follows another in this process can miss its first
        # few kernels: let some fills and a moment go by first.
        for _ in range(32):
            marker.fill_(0.0)
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _, fn in groups:
            marker.fill_(1.0)
            for _ in range(reps):
                fn()
        marker.fill_(1.0)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == cuda)
    fills = [start for start, _, name in kernels if "FillFunctor" in name][-len(groups) - 1:]
    out = []
    for i, (symbol, _) in enumerate(groups):
        pattern = re.compile(re.escape(symbol) + r"[<I(]")
        lo, hi = (fills[i], fills[i + 1]) if len(fills) == len(groups) + 1 else (0.0, -1.0)
        spans = [end - start for start, end, name in kernels
                 if lo < start < hi and pattern.search(name)]
        if len(spans) != reps:
            print(f"_device_ms: {len(spans)} {symbol} kernels in group {i} of {len(groups)}, "
                  f"expected {reps} ({len(kernels)} kernels, {len(fills)} fills in the window)")
        out.append(sum(spans) / reps / 1e3 if len(spans) == reps else None)
    return out


def _host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """The host's µs per call of ``fn``: the wall time to make ``calls``
    calls, synchronised before and after (the launch queue holds them all,
    so the device's pace does not hold the host back)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return enqueued / calls * 1e6


def _readings(ms: float, device, host: float, summed: bool = False) -> str:
    """A kernel's three times: back to back, the card's own, the host's (per
    launch, or ``summed`` over shapes)."""
    dev = "not measured" if device is None else f"{device:.4f} ms"
    per = ("summed", "summed") if summed else ("per launch", "per call")
    return (f"back to back {ms:.4f} ms | device {dev} {per[0]} | host {host:.1f} µs {per[1]}"
            + (" (above the device: the host sets the pace)"
               if device is not None and host / 1e3 > device else ""))


def _ptxas_lines(report: str) -> list:
    """One line per kernel from ptxas's report: name<dtype,vector>,
    registers, spills."""
    import re

    lines, name = [], None
    for ln in report.splitlines():
        m = re.search(r"entry function '.*?(bodymask_kernel|avg_pool2_bwd_kernel|"
                      r"bilinear_up2_bwd_kernel|avg_pool2_kernel|bilinear_up2_kernel)"
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


def _write_series(img, directory: str) -> None:
    """``img`` as an uncompressed DICOM series (``ct_0000.dcm`` ...) written
    by the port's writer into the new ``directory``."""
    from lungmask_tpu_torch.io import loader

    os.makedirs(directory)
    loader.write_dicom_series(img, os.path.join(directory, "ct.dcm"))


def _kernels():
    """The launch-counted wrappers: K1, K2, K3, K2ᵀ, K3ᵀ."""
    from lungmask_tpu_torch.ops.kernels import bodymask, stencil

    return {
        "bodymask_labels": bodymask.bodymask_labels,
        "avg_pool2": stencil.avg_pool2,
        "bilinear_up2": stencil.bilinear_up2,
        "avg_pool2_bwd": stencil.avg_pool2_bwd,
        "bilinear_up2_bwd": stencil.bilinear_up2_bwd,
    }


def _reset_launches() -> None:
    for fn in _kernels().values():
        fn.launches = 0


def _launches(names=FORWARD) -> dict:
    kernels = _kernels()
    return {name: kernels[name].launches for name in names}


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures = []
        self.state = {}

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            before = self.torch.cuda.current_device()
            fn()
            after = self.torch.cuda.current_device()
            self.check(after == before, f"the current CUDA device moved from {before} to {after}")
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
        from lungmask_tpu_torch.io import codecs
        from lungmask_tpu_torch.ops import native
        from lungmask_tpu_torch.ops.kernels import bodymask as k1
        from lungmask_tpu_torch.ops.kernels import stencil

        def timed(fn):
            t0 = time.perf_counter()
            out = fn()
            return out, time.perf_counter() - t0

        # One compiler per source, all started together.
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=4) as ex:
            jobs = [ex.submit(timed, fn) for fn in (k1.build, stencil.build, native.native_loaded,
                                                     codecs.get_lib)]
            (_, t_k1), (_, t_st), (loaded, t_host), (codec_lib, t_codec) = [
                job.result() for job in jobs]
        wall = time.perf_counter() - t0
        print(f"[build] K1 nvcc {t_k1:.2f} s | K2+K3 nvcc {t_st:.2f} s | host core g++ "
              f"{t_host:.2f} s | DICOM codecs g++ {t_codec:.2f} s | all, in parallel, "
              f"{wall:.2f} s")
        print(f"[build] DICOM codec library: {codec_lib._name if codec_lib else None}")
        # The codecs fall back to pure-Python RLE without a compiler; a failed
        # build must not hide behind that fallback.
        build_dir = os.path.realpath(os.path.join(REPO, "lungmask_tpu_torch", "_build"))
        self.check(codec_lib is not None and os.path.dirname(os.path.realpath(codec_lib._name))
                   == build_dir, f"the native DICOM codec library is not in {build_dir}")
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
        cases = [("avg_pool2", s) for s in POOL_SHAPES + TRAIN_POOL_SHAPES]
        cases += [("bilinear_up2", s) for s in UP_SHAPES + TRAIN_UP_SHAPES]
        cases += [(name, s) for s in ODD_SHAPES for name in ops]
        cases += [("bilinear_up2", s) for s in TILE_SHAPES + VOLUME96_SHAPES]
        cases += [("avg_pool2", s) for s in pool96]
        errs = {name: 0.0 for name in ops}
        timed = []
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
                self.check(same, f"{name} differs from its plain version at {shape} {dt}")
                per = [p for p, shapes in TIMED.items() if shape in shapes]
                if not (dtype == torch.bfloat16 and per):
                    print(f"[stencil] {name} {shape} {dt}: max_abs_err {err} bit-equal {same}")
                    continue
                med = _in_turns(torch, {"kernel": lambda: kern(x), "plain": lambda: plain(x),
                                        "library": lambda: lib(x)})
                bound_ms, by = _bound((x.numel() + got.numel()) * x.element_size(),
                                      got.numel() * ops_per_out)
                timed.append((name, shape, per[0], lambda kern=kern, x=x: kern(x), med, bound_ms,
                              by))
        self.state["stencil"] = self._timed_lines(
            "stencil", timed, {name: op[2] for name, op in ops.items()}, errs)

    def _timed_lines(self, tag, timed, libs, errs):
        """Print each timed bf16 shape's three readings — back to back, the
        card's own ms per launch (one profiler window over every shape, the
        kernels named ``<name>_kernel``), the host's µs per call — beside
        its bound, plain and library (``libs[name]``) times, then their sums
        per 32-slice chunk and per train step. ``timed`` holds (name, shape,
        "chunk" or "step", one call of the wrapper, in-turns medians, bound
        ms, bound by). Returns each kernel's entry of the kernels line, per
        chunk (K2, K3) or per step (K2ᵀ, K3ᵀ)."""
        torch = self.torch
        device = _device_ms(torch, [(f"{name}_kernel", fn) for name, _, _, fn, *_ in timed])
        host = [_host_us(torch, fn) for _, _, _, fn, *_ in timed]
        sums = {name: {per: {"kernel": 0.0, "plain": 0.0, "library": 0.0, "bound": 0.0,
                             "device": 0.0, "host": 0.0} for per in TIMED} for name in libs}
        bound_by = {name: set() for name in libs}
        for (name, shape, per, _, med, bound_ms, by), dev_ms, host_us in zip(timed, device, host):
            bound_by[name].add(by)
            t = sums[name][per]
            for k in med:
                t[k] += med[k]
            t["bound"] += bound_ms
            t["device"] = None if dev_ms is None or t["device"] is None else t["device"] + dev_ms
            t["host"] += host_us
            slower = [k for k in ("plain", "library") if med["kernel"] > med[k]]
            note = f" | SLOWER than {' and '.join(slower)}; the kernel stays" if slower else ""
            share = "" if dev_ms is None else f", of the device time {bound_ms / dev_ms:.1%}"
            print(f"[{tag}] {name} {shape} bfloat16: bit-equal True | "
                  f"{_readings(med['kernel'], dev_ms, host_us)} | bound {bound_ms:.4f} ms ({by}), "
                  f"share {bound_ms / med['kernel']:.1%}{share} | plain {med['plain']:.4f} ms | "
                  f"{libs[name]} {med['library']:.4f} ms{note}")
        for name in libs:
            for per, what in (("chunk", "32-slice bf16 chunk"),
                              ("step", f"bf16 train step of batch {TRAIN_BATCH}")):
                t = sums[name][per]
                share = ("" if t["device"] is None
                         else f", of the device time {t['bound'] / t['device']:.1%}")
                print(f"[{tag}] {name} per {what} (sum of the U-Net's 4 shapes): "
                      f"{_readings(t['kernel'], t['device'], t['host'], True)} | bound "
                      f"{t['bound']:.4f} ms ({'+'.join(sorted(bound_by[name]))}), share "
                      f"{t['bound'] / t['kernel']:.1%}{share} | plain {t['plain']:.4f} ms | "
                      f"{libs[name]} {t['library']:.4f} ms (back to back: medians of 10 "
                      f"CUDA-event runs of {REPS} launches each, in turns; device: "
                      f"torch.profiler over {REPS} launches; host: {HOST_CALLS} calls; "
                      f"{self.state['smi']})")
        main = {"avg_pool2": "chunk", "bilinear_up2": "chunk"}  # else per train step
        out = {}
        for name in libs:
            t = sums[name][main.get(name, "step")]
            out[name] = {"max_abs_err": errs[name], "ms": t["kernel"], "plain_ms": t["plain"],
                         "bound_ms": t["bound"], "bound_by": "+".join(sorted(bound_by[name])),
                         "library_ms": t["library"]}
        return out

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
        self.check(_launches(BACKWARD) == {k: 0 for k in BACKWARD},
                   f"inference launched an adjoint: {_launches(BACKWARD)}")
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
        self.state["mask"] = m
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

    def dicom(self):
        import numpy as np

        from lungmask_tpu_torch.io import dicom, image, loader

        tmp, vol, inferer = self.state["tmp"], self.state["phantom"], self.state["inferer"]
        times = {}
        src = image.MedicalImage(vol, spacing=(0.7, 0.7, 2.5), metadata=dict(KEPT_TAGS))
        series = os.path.join(tmp, "series")
        t0 = time.perf_counter()
        _write_series(src, series)
        times[f"write {len(vol)} uncompressed"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = loader.load_input_image(series, disable_tqdm=True, read_metadata=True)
        times[f"scan+decode {len(vol)} uncompressed"] = time.perf_counter() - t0
        self.check(np.array_equal(img.array, vol) and img.spacing == (0.7, 0.7, 2.5),
                   f"the series reads back as {img.array.shape} {img.array.dtype} {img.spacing}")
        nii = os.path.join(tmp, "series.nii")
        loader.write_image(image.MedicalImage(vol, spacing=(0.7, 0.7, 2.5)), nii)
        nii_img = loader.load_input_image(nii)
        want = inferer.apply(vol)
        expect = {"bodymask_labels": 1, "avg_pool2": 24, "bilinear_up2": 24}
        walls = {"dicom": [], "nifti": []}
        for name in ("dicom", "nifti", "nifti", "dicom", "dicom", "nifti"):  # in turns
            _reset_launches()
            t0 = time.perf_counter()
            mask = inferer.apply(img if name == "dicom" else nii_img)
            walls[name].append(time.perf_counter() - t0)
            launches = _launches()
            self.check(launches == expect, f"launches {launches} from {name}, expected {expect}")
            self.check(np.array_equal(mask, want), f"the mask from {name} differs from apply(array)")
        print(f"[dicom] {len(vol)}-slice series: every apply launched {expect} and its mask equals "
              f"apply(array)'s voxel for voxel, labels {sorted(int(v) for v in np.unique(want))}")
        print("[dicom] apply s, in turns: " + " | ".join(
            f"from {name} " + ", ".join(f"{t:.4f}" for t in ts) for name, ts in walls.items()))

        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        for ext in (".nii.gz", ".dcm"):
            out_dir = os.path.join(tmp, f"cli_dicom_{ext.strip('.').replace('.', '_')}")
            os.makedirs(out_dir)
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "lungmask_tpu_torch", series,
                 os.path.join(out_dir, "mask" + ext), "--modelpath", self.state["weights"],
                 "--noprogress"],
                capture_output=True, text=True, cwd=REPO, env=env, timeout=600,
            )
            times[f"CLI series -> {ext}"] = time.perf_counter() - t0
            self.check(res.returncode == 0, f"CLI to {ext} failed:\n{res.stderr[-4000:]}")
            back = loader.load_input_image(out_dir if ext == ".dcm" else
                                           os.path.join(out_dir, "mask" + ext),
                                           disable_tqdm=True, read_metadata=True)
            self.check(np.array_equal(back.array, want), f"the CLI's {ext} mask differs from apply")
            if ext == ".dcm":
                kept = {k: back.metadata.get(k) for k in KEPT_TAGS}
                self.check(kept == KEPT_TAGS and back.metadata.get("0008|103e")
                           == "Created with lungmask", f"kept tags {kept}")
            print(f"[dicom] CLI SERIES_DIR -> mask{ext}: rc 0, read back equals apply"
                  + (f", kept tags {sorted(KEPT_TAGS)} survive" if ext == ".dcm" else ""))

        rle_dir = os.path.join(tmp, "series_rle")
        os.makedirs(rle_dir)
        t0 = time.perf_counter()
        for z in range(RLE_SLICES):
            dicom.write_slice(os.path.join(rle_dir, f"{z:04d}.dcm"), vol[z],
                              series_uid="1.2.826.0.1.3680043.10.1464.3.2",
                              position=(0.0, 0.0, 2.5 * z), spacing=(0.7, 0.7),
                              slice_thickness=2.5, transfer_syntax=dicom.RLE_LOSSLESS)
        times[f"RLE-encode {RLE_SLICES}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rle = loader.load_input_image(rle_dir, disable_tqdm=True)
        times[f"scan+decode {RLE_SLICES} RLE"] = time.perf_counter() - t0
        self.check(np.array_equal(rle.array, vol[:RLE_SLICES]), "the RLE series differs")
        self.check(np.array_equal(inferer.apply(rle), inferer.apply(vol[:RLE_SLICES])),
                   "the RLE series' mask differs from the uncompressed slices' mask")
        print(f"[dicom] {RLE_SLICES}-slice RLE series: pixels and mask equal the uncompressed ones")
        self._codecs(vol[len(vol) // 2])
        print("[dicom] seconds: " + " | ".join(f"{k} {v:.4f}" for k, v in times.items())
              + f" ({self.state['smi']})")

    def _codecs(self, hu):
        """One slice through each syntax the port encodes without Pillow or
        CharLS, and the committed fixtures, decoded bit-exactly."""
        import numpy as np

        from lungmask_tpu_torch.io import dicom
        from lungmask_tpu_torch.models.synthetic import codec_slice

        u12 = np.clip(hu.astype(np.int32) + 1024, 0, 4095).astype(np.int16)
        u8 = np.clip((hu.astype(np.int32) + 1024) // 8, 0, 255).astype(np.int16)
        cases = [  # (name, syntax, stored pixels, rescale, expected HU, tolerance)
            ("explicit LE", dicom.EXPLICIT_VR_LE, hu, 0.0, hu, 0),
            ("deflated", dicom.DEFLATED_EXPLICIT_VR_LE, hu, 0.0, hu, 0),
            ("big endian", dicom.EXPLICIT_VR_BE, hu, 0.0, hu, 0),
            ("RLE", dicom.RLE_LOSSLESS, hu, 0.0, hu, 0),
            ("JPEG-lossless SV1", dicom.JPEG_LOSSLESS_SV1, hu, 0.0, hu, 0),
            (f"HTJ2K {HTJ2K_CROP}²", dicom.HTJ2K_LOSSLESS, hu[:HTJ2K_CROP, :HTJ2K_CROP], 0.0,
             hu[:HTJ2K_CROP, :HTJ2K_CROP], 0),
            ("DCT baseline 8-bit", dicom.JPEG_BASELINE, u8, 0.0, u8, DCT_TOLERANCE),
            ("DCT extended 12-bit", dicom.JPEG_EXTENDED, u12, -1024.0, u12 - 1024, DCT_TOLERANCE),
        ]
        lines = []
        for i, (name, syntax, stored, intercept, expect, tol) in enumerate(cases):
            path = os.path.join(self.state["tmp"], f"codec{i}.dcm")
            t0 = time.perf_counter()
            dicom.write_slice(path, stored, transfer_syntax=syntax, rescale=(1.0, intercept))
            t_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = dicom.read_file(path).pixels
            t_dec = time.perf_counter() - t0
            err = int(np.abs(got.astype(np.int32) - expect.astype(np.int32)).max())
            lines.append(f"{name} {stored.shape[0]}² enc {t_enc:.4f} s dec {t_dec:.4f} s "
                         f"max_abs_err {err}")
            self.check(got.shape == expect.shape and err <= tol, f"{name}: max_abs_err {err}")
        for name in sorted(os.listdir(os.path.join(REPO, FIXTURE_DIR))):
            t0 = time.perf_counter()
            got = dicom.read_file(os.path.join(REPO, FIXTURE_DIR, name))
            t_dec = time.perf_counter() - t0
            same = np.array_equal(got.pixels, codec_slice(FIXTURE_SEED))
            lines.append(f"fixture {name} ({got.get('0002|0010')}) dec {t_dec:.4f} s "
                         f"bit-exact {same}")
            self.check(same, f"the fixture {name} decodes to other pixels")
        for line in lines:
            print(f"[dicom] codec {line}")

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

    def _series_dir(self, stem):
        from lungmask_tpu_torch.io import image

        path = os.path.join(self.state["tmp"], stem)
        _write_series(image.MedicalImage(self.state["phantom"][:SERIES_SLICES],
                                         spacing=(0.7, 0.7, 2.5)), path)
        return path

    def cohort(self):
        import numpy as np

        from lungmask_tpu_torch.io import loader
        from lungmask_tpu_torch.runtime.cohort import run_cohort

        paths = self._write_volumes(COHORT_SLICES, "cohort") + [self._series_dir("cohort_series")]
        chunks = sum(-(-n // CHUNK) for n in COHORT_SLICES + (SERIES_SLICES,))
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
                  f"NIfTI + {SERIES_SLICES} DICOM slices of 512²) in {stats.wall_seconds:.4f} s = "
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
        uploads = []  # (query, body)
        for path in paths:
            with open(path, "rb") as fh:
                uploads.append(("name=v.nii&out=.nii.gz", fh.read()))
        series = self._series_dir("serve_series")
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as zf:
            for leaf in sorted(os.listdir(series)):
                zf.write(os.path.join(series, leaf), f"DICOM/{leaf}")
        uploads.append(("name=series.zip&out=.dcm", buf.getvalue()))
        paths.append(series)
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
                    query, body = uploads[i]
                    req = urllib.request.Request(base + "/v1/segment?" + query, data=body,
                                                 method="POST")
                    with urllib.request.urlopen(req, timeout=300) as r:
                        results[i] = (r.status, r.read(), r.headers.get("Content-Type"))

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
        print(f"[serve] {len(uploads)} uploads ({len(paths) - 1} NIfTI, one zipped "
              f"{SERIES_SLICES}-slice DICOM series answered as .dcm) from 2 clients in {wall:.4f} s = "
              f"{3600 * len(uploads) / wall:.1f} volumes/h | launches {launches} | service "
              f"s: " + " ".join(f"{k} {v:.4f}" for k, v in metrics.items()
                                if k.endswith("seconds")))
        self.check(all(r is not None and r[0] == 200 for r in results), "a request failed")
        self.check(all(v > 0 for v in launches.values()), f"launches {launches}")
        for (status, body, ctype), path in zip(results, paths):
            if ctype == "application/zip":  # the .dcm answer: a zipped series
                out = os.path.join(self.state["tmp"], "serve_dcm")
                with zipfile.ZipFile(io.BytesIO(body)) as zf:
                    zf.extractall(out)
                got = loader.load_input_image(out, disable_tqdm=True).array
            else:
                got = loader.load_input_bytes(bytearray(body), "m.nii.gz").array
            ref = inferer.apply(loader.load_input_image(path, disable_tqdm=True))
            self.check(np.array_equal(got, ref), f"the response for {path} differs from apply")
        print("[serve] every response equals apply's")

    def devprep(self):
        import numpy as np

        from lungmask_tpu_torch import LMInferer
        from lungmask_tpu_torch.metrics import compare_masks

        vol, hybrid = self.state["phantom"], self.state["inferer"]
        inferer = LMInferer(modelpath=self.state["weights"], tqdm_disable=True,
                            preprocessing="device")
        self.check(inferer.device.type == "cuda", f"device-mode inferer on {inferer.device}")
        inferer.apply(vol)  # warm-up
        _reset_launches()
        mask = inferer.apply(vol)
        launches = _launches(FORWARD + BACKWARD)
        chunks = -(-len(vol) // CHUNK)
        want = {"bodymask_labels": 1, "avg_pool2": 4 * chunks, "bilinear_up2": 4 * chunks,
                "avg_pool2_bwd": 0, "bilinear_up2_bwd": 0}
        self.check(launches == want, f"launches {launches}, expected {want}")
        pre, hyb = inferer.preprocess_image(vol), hybrid.preprocess_image(vol)
        self.check(pre["normalized"].is_cuda and pre["normalized"].shape == (len(vol), 256, 256),
                   f"stack {tuple(pre['normalized'].shape)} on {pre['normalized'].device}")
        same_boxes = bool(np.array_equal(pre["boxes"], hyb["boxes"]))
        stack_diff = float((pre["normalized"].float() - hyb["normalized"].float()).abs().max())
        cmp = compare_masks(mask, self.state["mask"])
        print(f"[devprep] launches in one apply: {launches} | boxes equal the hybrid boxes: "
              f"{same_boxes} | max |stack difference| against hybrid (bf16) {stack_diff:.3e} | "
              f"mask vs hybrid: voxel agreement {cmp.voxel_accuracy:.6f}, macro Dice "
              f"{cmp.macro_dice:.6f} | labels {sorted(int(v) for v in np.unique(mask))}")
        self.check(same_boxes, "device boxes differ from the hybrid boxes")
        self.check(mask.shape == vol.shape and mask.dtype == np.uint8, f"mask {mask.shape}")
        walls = {"device": [], "hybrid": []}
        stages = {"device": [], "hybrid": []}
        for name in ("device", "hybrid", "hybrid", "device", "device", "hybrid"):  # in turns
            inf = inferer if name == "device" else hybrid
            inf.timings.reset()
            t0 = time.perf_counter()
            inf.apply(vol)
            walls[name].append(time.perf_counter() - t0)
            stages[name].append(inf.timings.summary().get("preprocess", 0.0))
        for name in walls:
            print(f"[devprep] {name} apply s, in turns: "
                  + ", ".join(f"{t:.4f}" for t in walls[name]) + " | preprocess stage s: "
                  + ", ".join(f"{t:.4f}" for t in stages[name]) + f" ({self.state['smi']})")

    def _adjoints(self):
        """K2ᵀ and K3ᵀ bit-equal to their plain adjoints at the U-Net's shapes
        in a train step (batch 8), an inference chunk (32) and a data-2
        shard's step (4), bf16 and f32, and at the odd, tile-straddling and
        padded band shapes; the bf16 times per train step and per chunk —
        back to back, the card's own per launch, the host's per call —
        beside the bound, the plain adjoint and torch's own backward op."""
        torch = self.torch
        from lungmask_tpu_torch.ops.kernels import stencil as st

        aten = torch.ops.aten
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(1)

        def pool_out(s):
            return (s[0], s[1] // 2, s[2] // 2, s[3])

        def up_out(s):
            return (s[0], 2 * s[1], 2 * s[2], s[3])

        def nchw(t):
            return t.permute(0, 3, 1, 2)

        ops = {  # name: (output shape, kernel, plain, library backward, operations per dx)
            "avg_pool2_bwd": (
                pool_out,
                lambda g, s: st.avg_pool2_bwd(g, s),
                lambda g, s: st.avg_pool2_bwd_reference(g, s),
                lambda g, s: aten.avg_pool2d_backward(
                    nchw(g), torch.empty(s, dtype=g.dtype, device=dev).permute(0, 3, 1, 2),
                    [2, 2], [2, 2], [0, 0], False, True, None),
                1,
            ),
            # 7 per row-pass value (H x 2W of them) and 7 per output: 21.
            "bilinear_up2_bwd": (
                up_out,
                lambda g, s: st.bilinear_up2_bwd(g),
                lambda g, s: st.bilinear_up2_bwd_reference(g),
                lambda g, s: aten.upsample_bilinear2d_backward(
                    nchw(g), [2 * s[1], 2 * s[2]], [s[0], s[3], s[1], s[2]], False, 2.0, 2.0),
                21,
            ),
        }
        cases = [("avg_pool2_bwd", s) for s in POOL_SHAPES + TRAIN_POOL_SHAPES]
        cases += [("bilinear_up2_bwd", s) for s in UP_SHAPES + TRAIN_UP_SHAPES]
        cases += [(name, s) for s in ODD_SHAPES for name in ops]
        cases += [("bilinear_up2_bwd", s) for s in TILE_SHAPES + ADJOINT_TILE_SHAPES]
        cases += [("bilinear_up2_bwd", (TRAIN_BATCH, h // 2 + pad, w, c))  # padded bands
                  for _, h, w, c in UP_SHAPES for pad in (1, 2)]
        half = TRAIN_BATCH // 2  # a shard's batch in the data-2 mesh's train step
        cases += [("avg_pool2_bwd", (half,) + s[1:]) for s in POOL_SHAPES]
        cases += [("bilinear_up2_bwd", (half,) + s[1:]) for s in UP_SHAPES]
        errs = {name: 0.0 for name in ops}
        timed = []
        for name, shape in cases:
            out_shape, kern, plain, lib, ops_per_dx = ops[name]
            for dtype in (torch.bfloat16, torch.float32):
                g = torch.randn(out_shape(shape), generator=gen, device=dev).to(dtype)
                got, want = kern(g, shape), plain(g, shape)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                same = torch.equal(got.view(bits), want.view(bits))
                errs[name] = max(errs[name], err)
                dt = str(dtype).split(".")[-1]
                self.check(same, f"{name} differs from its plain adjoint at {shape} {dt}")
                per = [p for p, shapes in TIMED.items() if shape in shapes]
                if not (dtype == torch.bfloat16 and per):
                    print(f"[train] {name} {shape} {dt}: max_abs_err {err} bit-equal {same}")
                    continue
                lib_err = float((lib(g, shape).permute(0, 2, 3, 1).float()
                                 - want.float()).abs().max())
                print(f"[train] {name} {shape} bfloat16: library backward's max |diff| to the "
                      f"plain adjoint {lib_err:.3e}")
                med = _in_turns(torch, {"kernel": lambda: kern(g, shape),
                                        "plain": lambda: plain(g, shape),
                                        "library": lambda: lib(g, shape)})
                bound_ms, by = _bound((g.numel() + got.numel()) * g.element_size(),
                                      got.numel() * ops_per_dx)
                timed.append((name, shape, per[0], lambda kern=kern, g=g, shape=shape:
                              kern(g, shape), med, bound_ms, by))
        # Per train step, the one path that launches them.
        self.state["adjoints"] = self._timed_lines(
            "train", timed, {"avg_pool2_bwd": "aten.avg_pool2d_backward",
                             "bilinear_up2_bwd": "aten.upsample_bilinear2d_backward"}, errs)

    def train(self):
        import numpy as np

        torch = self.torch
        from lungmask_tpu_torch.models import unet
        from lungmask_tpu_torch.train import default_optimizer, fit, init_train_state
        from lungmask_tpu_torch.train import make_train_step
        from lungmask_tpu_torch.train.checkpoint import load_train_state
        from lungmask_tpu_torch.train.data import SliceDataset, slices_from_pair

        dev = torch.device("cuda", 0)
        vol, mask = self.state["phantom"], self.state["mask"]
        tmp = self.state["tmp"]
        _reset_launches()
        t0 = time.perf_counter()
        ds = SliceDataset([(vol[:TRAIN_SLICES], mask[:TRAIN_SLICES])], device=dev)
        ev = slices_from_pair(vol[TRAIN_SLICES : TRAIN_SLICES + EVAL_SLICES],
                              mask[TRAIN_SLICES : TRAIN_SLICES + EVAL_SLICES], device=dev)
        t_data = time.perf_counter() - t0
        data_launches = _launches(FORWARD + BACKWARD)
        print(f"[train] slices_from_pair on the card: {len(ds)} train + {len(ev[0])} eval slices "
              f"of 256² in {t_data:.4f} s, launches {data_launches}, label classes "
              f"{sorted(int(v) for v in np.unique(ds.labels))}")
        self.check(data_launches == {"bodymask_labels": 2, "avg_pool2": 0, "bilinear_up2": 0,
                                     "avg_pool2_bwd": 0, "bilinear_up2_bwd": 0},
                   f"data launches {data_launches}")
        params = unet.init_params(3, generator=torch.Generator().manual_seed(0))
        steps = TRAIN_EPOCHS * (TRAIN_SLICES // TRAIN_BATCH)
        opt = default_optimizer(steps, peak_lr=TRAIN_PEAK_LR)
        kw = dict(batch_size=TRAIN_BATCH, optimizer=opt, seed=0, log_every=1,
                  compute_dtype=torch.bfloat16, device=dev)
        deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            ck = os.path.join(tmp, "train_state.npz")
            _reset_launches()
            t0 = time.perf_counter()
            res = fit(params, ds, epochs=TRAIN_EPOCHS, eval_pairs=ev, eval_every=steps // 2,
                      checkpoint_path=ck, checkpoint_every=steps // 2, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches(FORWARD + BACKWARD)
            self.state["train_launches"] = launches
            losses = [h["loss"] for h in res.history if "loss" in h]
            dice = [h["eval_macro_dice"] for h in res.history if "eval_macro_dice" in h]
            chunks = 2 * -(-EVAL_SLICES // TRAIN_BATCH)  # two evaluations
            want = {"bodymask_labels": 0, "avg_pool2": 4 * (steps + chunks),
                    "bilinear_up2": 4 * (steps + chunks), "avg_pool2_bwd": 4 * steps,
                    "bilinear_up2_bwd": 4 * steps}
            print(f"[train] fit: {steps} steps of batch {TRAIN_BATCH} (wf=6, bf16, 256²) + 2 "
                  f"evaluations in {wall:.4f} s | launches {launches} | losses "
                  + ", ".join(f"{v:.5f}" for v in losses) + " | eval macro Dice "
                  + ", ".join(f"{v:.6f}" for v in dice))
            self.check(launches == want, f"fit launches {launches}, expected {want}")
            self.check(len(losses) == steps and all(np.isfinite(losses)), f"losses {losses}")
            self.check(np.mean(losses[-3:]) < np.mean(losses[:3]), "the loss did not fall")
            self.check(len(dice) == 2 and all(np.isfinite(dice)), f"eval Dice {dice}")
            self.check(os.path.exists(ck), "no checkpoint written")

            # The same run cut at step 8, then resumed from its checkpoint.
            ck8 = os.path.join(tmp, "train_state_step8.npz")
            half = fit(params, ds, epochs=1, checkpoint_path=ck8, **kw)
            first = [h["loss"] for h in half.history if "loss" in h]
            state, _ = load_train_state(ck8, init_train_state(params, opt, dev))
            step_fn = make_train_step(opt, compute_dtype=torch.bfloat16)
            resumed = []
            for im, lb in list(ds.batches(TRAIN_BATCH, seed=0, epochs=TRAIN_EPOCHS))[steps // 2:]:
                state, loss = step_fn(state, im, lb)
                resumed.append(float(loss))
            ref = losses[steps // 2:]
            exact = resumed == ref and first == losses[: steps // 2]
            rel = float(np.max(np.abs(np.subtract(resumed, ref)) / np.abs(ref)))
            print(f"[train] resume from the step-{steps // 2} checkpoint (cudnn.deterministic): "
                  f"{'bit for bit' if exact else f'max relative loss difference {rel:.3e}'} "
                  f"against the uninterrupted run | resumed losses "
                  + ", ".join(f"{v:.5f}" for v in resumed))
            self.check(exact or rel <= RESUME_RTOL, f"resumed losses differ by {rel}")
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic

        # One step's launches, then its time after 2 warm steps.
        state = init_train_state(params, opt, dev)
        step_fn = make_train_step(opt, compute_dtype=torch.bfloat16)
        im, lb = next(ds.batches(TRAIN_BATCH, seed=0))
        im, lb = torch.from_numpy(im).to(dev), torch.from_numpy(lb).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        state, _ = step_fn(state, im, lb)
        torch.cuda.synchronize()
        per_step = _launches(FORWARD + BACKWARD)
        want = {"bodymask_labels": 0, "avg_pool2": 4, "bilinear_up2": 4, "avg_pool2_bwd": 4,
                "bilinear_up2_bwd": 4}
        self.check(per_step == want, f"one step launched {per_step}, expected {want}")
        state, _ = step_fn(state, im, lb)
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step_fn(state, im, lb)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms = float(np.median(times))
        peak = torch.cuda.max_memory_allocated()
        print(f"[train] one step launches {per_step} | train step (batch {TRAIN_BATCH}, wf=6, "
              f"bf16, 256²): median {ms:.3f} ms of 10 after 2 warm steps (range "
              f"{min(times):.3f}-{max(times):.3f}), {TRAIN_BATCH * 1e3 / ms:.1f} slices/s | peak "
              f"memory {peak / 2**30:.3f} GiB ({self.state['smi']})")
        self._profile_steps(step_fn, state, im, lb)
        self._finetune_cli(params)
        self._adjoints()

    def _finetune_cli(self, params):
        """``python -m lungmask_tpu_torch.train.finetune`` on the card: three
        phantom pairs (NIfTI, 16 slices each; the last held out), one epoch
        from ``params``; its weights must load and apply."""
        import numpy as np

        from lungmask_tpu_torch import LMInferer
        from lungmask_tpu_torch.io import image, loader
        from lungmask_tpu_torch.models import convert

        vol, mask = self.state["phantom"], self.state["mask"]
        tmp = self.state["tmp"]
        data = os.path.join(tmp, "finetune_data")
        os.makedirs(data)
        for i in range(3):
            sl = slice(16 * i, 16 * (i + 1))
            loader.write_image(image.MedicalImage(vol[sl]), os.path.join(data, f"case{i}.nii.gz"))
            loader.write_image(image.MedicalImage(mask[sl]),
                               os.path.join(data, f"case{i}_mask.nii.gz"))
        start, out = os.path.join(tmp, "start.npz"), os.path.join(tmp, "tuned.npz")
        convert.save_npz(start, convert.to_jax_params(params))
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "lungmask_tpu_torch.train.finetune", data, out, "--model",
             start, "--epochs", "1"],
            capture_output=True, text=True, cwd=REPO, env=env, timeout=600,
        )
        wall = time.perf_counter() - t0
        self.check(res.returncode == 0, f"finetune failed:\n{res.stdout[-2000:]}\n"
                                        f"{res.stderr[-4000:]}")
        self.check("on cuda" in res.stdout, f"finetune did not run on the card: {res.stdout}")
        tuned = LMInferer(modelpath=out, tqdm_disable=True).apply(vol[:16])
        self.check(tuned.shape == (16,) + vol.shape[1:] and tuned.dtype == np.uint8,
                   f"the tuned weights gave {tuned.shape} {tuned.dtype}")
        print(f"[train] finetune CLI: rc 0 in {wall:.2f} s (process start, build check, 32 train "
              f"+ 16 eval slices, one epoch at wf=6) | "
              f"{res.stdout.strip().splitlines()[-1].split(';')[0]} | the weights apply: labels "
              f"{sorted(int(v) for v in np.unique(tuned))}")

    def _profile_steps(self, step_fn, state, im, lb, steps: int = 3):
        """Where a train step's time goes: ``torch.profiler`` over ``steps``
        steps — the device's busy time (the union of its kernels'
        intervals) against the wall, and the kernels with the most device
        time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = step_fn(state, im, lb)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        kernels = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                         if e.device_type == cuda)
        busy, end = 0.0, float("-inf")
        for a, b in kernels:  # µs; the union of the kernels' intervals
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        busy /= 1e3
        # Each operator's own kernels (self device time: no double counting
        # of nested operators).
        ops = sorted((e for e in prof.key_averages()
                      if e.device_type == cpu and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
        top = "; ".join(f"{e.key} {e.self_device_time_total / 1e3 / steps:.3f} ms x"
                        f"{e.count // steps}" for e in ops[:8])

        def copies(e):  # aten::copy_ under e: a gradient made contiguous before the kernel
            return sum((c.name == "aten::copy_") + copies(c) for c in e.cpu_children)

        for node in ("_AvgPool2Backward", "_BilinearUp2Backward"):
            nodes = [e for e in prof.events()
                     if e.device_type == cpu and e.name.endswith(f"evaluate_function: {node}")]
            print(f"[train] profile: {len(nodes)} {node} nodes in {steps} steps, "
                  f"{sum(copies(e) for e in nodes)} aten::copy_ inside them")
        print(f"[train] profile of {steps} steps: wall {wall / steps:.3f} ms per step (profiler "
              f"on), device busy {busy / steps:.3f} ms per step, idle share {1 - busy / wall:.1%}, "
              f"{len(kernels) // steps} kernels per step | operators by their kernels' time per "
              f"step: "
              f"{top or 'no device events recorded'}")


    def variants(self):
        """The residual, upconv and residual+upconv U-Nets at production
        width (wf=6) from seeded reference-layout state dicts."""
        import numpy as np

        torch = self.torch
        from lungmask_tpu_torch import LMInferer
        from lungmask_tpu_torch.models import convert, synthetic, unet
        from lungmask_tpu_torch.transforms import preprocess

        dev = torch.device("cuda", 0)
        vol = self.state["phantom"]
        x, _ = preprocess.preprocess_hybrid(vol[:CHUNK], device=dev)
        x = x.unsqueeze(-1)  # one 32-slice chunk, NHWC float32
        cpu_x = x[:VARIANT_CPU_SLICES].cpu()
        dicts = {}
        for name, (residual, up_mode) in VARIANTS.items():
            sd = synthetic.reference_state_dict(3, residual=residual, up_mode=up_mode,
                                                seed=VARIANT_SEED)
            dicts[name] = sd
            params = convert.convert_state_dict(sd)
            gpu32 = unet.UNet(convert.from_jax_params(params, dev), torch.float32).eval()
            gpu16 = unet.UNet(convert.from_jax_params(params, dev), torch.bfloat16).eval()
            cpu32 = unet.UNet(convert.from_jax_params(params), torch.float32).eval()
            with torch.inference_mode():
                _reset_launches()
                lg = gpu32(x)
                torch.cuda.synchronize()
                launches = _launches()
                t0 = time.perf_counter()
                lc = cpu32(cpu_x)
                t_cpu = time.perf_counter() - t0
                lg_cpu = lg[:VARIANT_CPU_SLICES].cpu()
                diff = (lg_cpu - lc).abs()
                within = bool((diff <= UNET_LOGIT_ATOL + UNET_LOGIT_RTOL * lc.abs()).all())
                same_argmax = torch.equal(lg_cpu.argmax(-1), lc.argmax(-1))
                a16 = unet.unet_argmax(gpu16, x)
                agree = float((a16 == lg.argmax(-1)).float().mean())
                ms16 = _median_ms(torch, lambda: unet.unet_argmax(gpu16, x), 5, reps=1)
                ms32 = _median_ms(torch, lambda: unet.unet_argmax(gpu32, x), 5, reps=1)
            am = lg.argmax(-1).reshape(-1).cpu().numpy()
            classes = np.bincount(am, minlength=3) / am.size
            want = {"bodymask_labels": 0, "avg_pool2": 4, "bilinear_up2": 0 if up_mode == "upconv" else 4}
            print(f"[variants] {name}: {CHUNK} slices 256² on the GPU, the first "
                  f"{VARIANT_CPU_SLICES} in f32 (TF32 off) vs CPU f32 ({t_cpu:.2f} s): "
                  f"max |dlogit| {float(diff.max()):.3e} of max |logit| {float(lc.abs().max()):.3e} "
                  f"(bound {UNET_LOGIT_ATOL} + {UNET_LOGIT_RTOL}*|x|), identical argmax "
                  f"{same_argmax}, class shares {np.round(classes, 4).tolist()} | bf16 argmax "
                  f"agreement with f32 {agree:.6f} | launches per forward {launches} | "
                  f"forward+argmax bf16 {ms16:.3f} ms, f32 {ms32:.3f} ms ({self.state['smi']})")
            self.check(within, f"{name}: GPU f32 logits outside the bound")
            self.check(same_argmax, f"{name}: GPU f32 argmax differs from CPU f32")
            self.check(agree >= BF16_MIN_AGREEMENT, f"{name}: bf16 agreement {agree}")
            self.check(launches == want, f"{name}: launches {launches}, expected {want}")

        # A variant checkpoint as the reference ships one: a .pth state dict.
        path = os.path.join(self.state["tmp"], "residual_upconv.pth")
        torch.save({k: torch.from_numpy(v) for k, v in dicts["residual+upconv"].items()}, path)
        inferer = LMInferer(modelpath=path, tqdm_disable=True)
        inferer.apply(vol[:CHUNK])  # warm-up
        _reset_launches()
        t0 = time.perf_counter()
        mask = inferer.apply(vol)
        wall = time.perf_counter() - t0
        launches = _launches()
        labels = sorted(int(v) for v in np.unique(mask))
        chunks = -(-len(vol) // CHUNK)
        want = {"bodymask_labels": 1, "avg_pool2": 4 * chunks, "bilinear_up2": 0}
        print(f"[variants] LMInferer(modelpath=<residual+upconv .pth>).apply of the {len(vol)}-slice "
              f"phantom: {wall:.4f} s | launches {launches} | labels {labels} | shape {mask.shape} "
              f"{mask.dtype}")
        self.check(mask.shape == vol.shape and mask.dtype == np.uint8, f"mask {mask.shape}")
        self.check(set(labels) <= {0, 1, 2}, f"labels {labels}")
        self.check(launches == want, f"launches {launches}, expected {want}")

    def mesh(self):
        """``LMInferer(mesh=)``, the sharded cleanup, ``fit(mesh=)`` and a
        one-process NCCL group on the card."""
        import numpy as np

        torch = self.torch
        from lungmask_tpu_torch import LMInferer
        from lungmask_tpu_torch.parallel import make_mesh, make_sharded_postprocess, multihost
        from lungmask_tpu_torch.parallel.mesh import shard_rows
        from lungmask_tpu_torch.transforms.postprocess_device import postprocess_device

        dev = torch.device("cuda", 0)
        vol = self.state["phantom"]
        meshes = {"make_mesh()": (make_mesh(), None),
                  "data-2 on cuda:0": (make_mesh(devices=[dev, dev]), MESH_BATCH)}
        ndata = {k: m.shape["data"] for k, (m, _) in meshes.items()}
        self.check(ndata["make_mesh()"] == torch.cuda.device_count(), f"meshes {ndata}")
        chunks = -(-len(vol) // CHUNK)
        pred = None
        for fused in (False, True):
            kw = (dict(modelname="LTRCLobes", fillmodel="R231") if fused
                  else dict(modelpath=self.state["weights"]))
            for post in ("exact", "device"):
                ref_inf = LMInferer(tqdm_disable=True, preprocessing="device",
                                    postprocessing_mode=post, **kw)
                ref = ref_inf.apply(vol)
                if not fused and post == "device":
                    pred = ref_inf.forward_preprocessed(ref_inf.preprocess_image(vol))
                note = ""
                if not fused and post == "exact":
                    note = (f" (that mask's voxel agreement with the hybrid main-path mask "
                            f"{float((ref == self.state['mask']).mean()):.6f})")
                for mname, (mesh, batch) in meshes.items():
                    inf = LMInferer(tqdm_disable=True, mesh=mesh, batch_size=batch,
                                    postprocessing_mode=post, **kw)
                    self.check(inf.preprocessing == "sharded", f"preprocessing {inf.preprocessing}")
                    inf.apply(vol[:CHUNK])  # warm-up
                    _reset_launches()
                    inf.timings.reset()
                    t0 = time.perf_counter()
                    mask = inf.apply(vol)
                    wall = time.perf_counter() - t0
                    launches = _launches(FORWARD + BACKWARD)
                    models = 2 if fused else 1
                    want = {"bodymask_labels": ndata[mname], "avg_pool2": 4 * chunks * models,
                            "bilinear_up2": 4 * chunks * models, "avg_pool2_bwd": 0,
                            "bilinear_up2_bwd": 0}
                    same = bool(np.array_equal(mask, ref))
                    st = inf.timings.summary()
                    stages = " ".join(f"{k} {st.get(k, 0.0):.4f}" for k in (
                        "preprocess", "unet", "postprocess", "paste_back", "fusion_postprocess"))
                    print(f"[mesh] {mname} {'fused' if fused else 'single'} {post}: {wall:.4f} s | "
                          f"stage s: {stages} | launches {launches} | equals the unsharded "
                          f"preprocessing='device' mask: {same}{note}")
                    self.check(same, f"{mname} {post} {'fused' if fused else 'single'}: the mesh's "
                                     "mask differs from the unsharded mask")
                    self.check(launches == want, f"launches {launches}, expected {want}")

        # The sharded cleanup of one class map on the card.
        two = meshes["data-2 on cuda:0"][0]
        step = make_sharded_postprocess(two, 3)
        single = postprocess_device(pred, 3)
        slabs = shard_rows(two, pred)
        step(slabs)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = step(slabs)
        torch.cuda.synchronize()
        t_sharded = time.perf_counter() - t0
        t0 = time.perf_counter()
        postprocess_device(pred, 3)
        torch.cuda.synchronize()
        t_single = time.perf_counter() - t0
        same = torch.equal(torch.cat(got), single)
        print(f"[mesh] make_sharded_postprocess of one {tuple(pred.shape)} class map over the "
              f"data-2 mesh: {t_sharded:.4f} s against postprocess_device {t_single:.4f} s | "
              f"bit-equal {same}")
        self.check(same and all(g.is_cuda for g in got), "the sharded cleanup differs")
        self._mesh_train(two)

    def _mesh_train(self, two):
        """``fit(mesh=)`` beside the unsharded fit (bf16, 4 steps of batch 8),
        one f32 step's loss and gradients against plain torch and the
        unsharded step, and one step through a one-process NCCL group."""
        import socket

        import numpy as np

        torch = self.torch
        from lungmask_tpu_torch.models import unet
        from lungmask_tpu_torch.parallel import multihost
        from lungmask_tpu_torch.train import default_optimizer, fit, init_train_state
        from lungmask_tpu_torch.train import make_train_step
        from lungmask_tpu_torch.train.data import SliceDataset

        dev = torch.device("cuda", 0)
        vol, mask = self.state["phantom"], self.state["mask"]
        ds = SliceDataset([(vol[:MESH_TRAIN_SLICES], mask[:MESH_TRAIN_SLICES])], device=dev)
        params = unet.init_params(3, generator=torch.Generator().manual_seed(0))
        steps = MESH_TRAIN_SLICES // TRAIN_BATCH
        kw = dict(batch_size=TRAIN_BATCH, optimizer=default_optimizer(steps, peak_lr=TRAIN_PEAK_LR),
                  seed=0, log_every=1, compute_dtype=torch.bfloat16)
        runs = {}
        for name, extra in (("unsharded", dict(device=dev)), ("data-2", dict(mesh=two))):
            _reset_launches()
            t0 = time.perf_counter()
            res = fit(params, ds, **kw, **extra)
            torch.cuda.synchronize()
            runs[name] = ([h["loss"] for h in res.history if "loss" in h],
                          time.perf_counter() - t0, _launches(FORWARD + BACKWARD))
        losses, wall, launches = runs["data-2"]
        want = {"bodymask_labels": 0, "avg_pool2": 8 * steps, "bilinear_up2": 8 * steps,
                "avg_pool2_bwd": 8 * steps, "bilinear_up2_bwd": 8 * steps}
        print(f"[mesh] fit(mesh=data-2 on cuda:0), {steps} bf16 steps of batch {TRAIN_BATCH} "
              f"({TRAIN_BATCH // 2} per shard, wf=6, 256²): {wall:.4f} s | launches {launches} "
              f"(K2/K3/K2ᵀ/K3ᵀ 4/4/4/4 per shard and step) | losses "
              + ", ".join(f"{v:.5f}" for v in losses) + " | unsharded fit: "
              + ", ".join(f"{v:.5f}" for v in runs["unsharded"][0])
              + f" in {runs['unsharded'][1]:.4f} s")
        self.check(launches == want, f"fit(mesh=) launches {launches}, expected {want}")
        self.check(len(losses) == steps and all(np.isfinite(losses)), f"losses {losses}")

        class Recorder:  # keeps the step's gradients, moves no weight
            def init(self, params):
                return None

            def update(self, grads, state, params):
                self.grads = {k: g.clone() for k, g in grads.items()}
                return {k: torch.zeros_like(g) for k, g in grads.items()}, state

        im, lb = next(ds.batches(TRAIN_BATCH, seed=0))
        lb = np.array(lb)
        lb[TRAIN_BATCH // 2 :] = 0  # halves with other classes: averaging their Dice is off

        def grads(mesh):
            rec = Recorder()
            state = init_train_state(params, rec, dev)
            _, loss = make_train_step(rec, mesh=mesh, compute_dtype=torch.float32)(state, im, lb)
            return float(loss), rec.grads

        def worst(a, b):  # the largest difference of a leaf, over that leaf's largest value
            return max(float((a[k] - g).abs().max() / g.abs().max()) for k, g in b.items())

        half = TRAIN_BATCH // 2

        def plain_at_parts(x, y, dice_weight=0.5, eps=1e-6):
            """The whole batch's loss and gradients in plain torch, with the
            model run on each half at the shards' shapes: the sums of the
            cross-entropy and of the Dice terms over both halves, one
            backward. Against the unsharded step on the whole batch, the
            convolutions' float32 backward at batch 4 differs from batch 8's
            (6.8e-4 of a leaf's largest gradient on the CPU at wf=2, 256²);
            at the same shapes, only the order of the sums can."""
            model = init_train_state(params, Recorder(), dev).model
            x, y = torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev).long()
            with torch.inference_mode(False), torch.enable_grad(), \
                    unet.conv_flags(torch.float32):
                sums = 0
                for i in (0, half):
                    logits = model.logits(x[i : i + half], torch.float32)
                    yi = y[i : i + half]
                    probs = torch.softmax(logits, -1)
                    onehot = torch.nn.functional.one_hot(yi, logits.shape[-1]).float()
                    nll = -torch.log_softmax(logits, -1).gather(-1, yi.unsqueeze(-1)).sum()
                    sums = sums + torch.cat([nll.view(1), (probs * onehot).sum((0, 1, 2)),
                                             (probs + onehot).sum((0, 1, 2))])
                c = (sums.shape[0] - 1) // 2
                dice = 1 - torch.mean((2 * sums[1 : 1 + c] + eps) / (sums[1 + c :] + eps))
                loss = (1 - dice_weight) * sums[0] / y.numel() + dice_weight * dice
                loss.backward()
            return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}

        l_ref, g_ref = grads(None)
        l_two, g_two = grads(two)
        l_plain, g_plain = plain_at_parts(im, lb)
        plain_worst = worst(g_two, g_plain)
        whole_worst = worst(g_two, g_ref)
        print(f"[mesh] one f32 step (batch {TRAIN_BATCH}, wf=6): loss data-2 {l_two:.7f} vs "
              f"unsharded {l_ref:.7f}, plain at the shards' shapes {l_plain:.7f} | gradients "
              f"against the plain ones: worst leaf difference {plain_worst:.3e} of its largest "
              f"(bound {GRAD_RTOL}) | against the unsharded batch of {TRAIN_BATCH}: "
              f"{whole_worst:.3e} (bound {GRAD_GROSS})")
        self.check(abs(l_two - l_ref) <= GRAD_RTOL * abs(l_ref), "the sharded f32 loss differs")
        self.check(abs(l_two - l_plain) <= GRAD_RTOL * abs(l_plain), "the sharded f32 loss differs")
        self.check(plain_worst <= GRAD_RTOL, f"the sharded f32 gradients differ by {plain_worst}")
        self.check(whole_worst <= GRAD_GROSS, f"the sharded f32 gradients differ by {whole_worst}")

        # Time the sharded bf16 step after a warm one.
        state = init_train_state(params, kw["optimizer"], dev)
        step_fn = make_train_step(kw["optimizer"], mesh=two, compute_dtype=torch.bfloat16)
        x, y = torch.from_numpy(im).to(dev), torch.from_numpy(lb).to(dev)
        state, _ = step_fn(state, x, y)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step_fn(state, x, y)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        print(f"[mesh] sharded train step (data-2 on one card, batch {TRAIN_BATCH}, bf16): median "
              f"{float(np.median(times)):.3f} ms of 5 (range {min(times):.3f}-{max(times):.3f}) "
              f"({self.state['smi']})")

        # One step through a one-process NCCL group: the all-reduce path.
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ok = multihost.initialize_multihost(f"127.0.0.1:{port}", num_processes=1, process_id=0)
        try:
            backend = torch.distributed.get_backend()
            l_grp, g_grp = grads(two)
        finally:
            torch.distributed.destroy_process_group()
        grp_worst = worst(g_grp, g_two)
        print(f"[mesh] one-process {backend} group (initialize_multihost -> {ok}): f32 step loss "
              f"{l_grp:.7f} vs {l_two:.7f} without the group, worst gradient leaf difference "
              f"{grp_worst:.3e}")
        self.check(ok and backend == "nccl", f"group {ok} {backend}")
        self.check(abs(l_grp - l_two) <= GRAD_RTOL * abs(l_two) and grp_worst <= GRAD_RTOL,
                   "the step through the group differs")


    def space(self):
        """The mesh's space axis on the card: height bands with halo rows
        through the production U-Net on one 32-slice chunk, the stencils at
        the bands' shapes, ``LMInferer(mesh=)`` over a 1x2 and a 2x2 mesh
        on one card, the banded cleanup and ``fit(mesh=1x2)``."""
        import numpy as np

        torch = self.torch
        from lungmask_tpu_torch.models import convert, unet
        from lungmask_tpu_torch.parallel import make_mesh
        from lungmask_tpu_torch.parallel.halo import Bands
        from lungmask_tpu_torch.parallel.mesh import split_bands
        from lungmask_tpu_torch.transforms import preprocess

        dev = torch.device("cuda", 0)
        x, _ = preprocess.preprocess(self.state["phantom"][:CHUNK], device=dev)
        x = x.unsqueeze(-1)  # (32, 256, 256, 1)
        bounds = split_bands(x.shape[1], 2)
        with torch.inference_mode():
            for name, params in (("crafted", self.state["params"]), ("random", _random_params(0))):
                logits = {}
                for dtype in (torch.float32, torch.bfloat16):
                    model = unet.UNet(convert.from_jax_params(params, dev), dtype).eval()
                    _reset_launches()
                    banded = model.logits(Bands([x[:, a:b] for a, b in bounds]))
                    launches = _launches()
                    whole = model.logits(x)
                    logits[dtype] = (torch.cat(banded.parts, dim=1), whole)
                    ms = {k: _median_ms(torch, fn, 5, reps=1) for k, fn in (
                        ("banded", lambda: model.logits(Bands([x[:, a:b] for a, b in bounds]))),
                        ("whole", lambda: model.logits(x)))}
                    print(f"[space] {name} weights, {str(dtype).split('.')[-1]} forward of one "
                          f"32-slice chunk: 2 bands {ms['banded']:.3f} ms, whole "
                          f"{ms['whole']:.3f} ms | launches per band "
                          f"{ {k: v / 2 for k, v in launches.items()} }")
                    want = {"bodymask_labels": 0, "avg_pool2": 8, "bilinear_up2": 8}
                    self.check(launches == want, f"banded launches {launches}, expected {want}")
                    if name == "random":
                        for what, fn in (("whole", lambda: model.logits(x)),
                                         ("2 bands", lambda: model.logits(
                                             Bands([x[:, a:b] for a, b in bounds])))):
                            self._space_profile(fn, f"{str(dtype).split('.')[-1]} {what}")
                got, whole = logits[torch.float32]
                err = float((got - whole).abs().max()) / float(whole.abs().max())
                same = torch.equal(got.argmax(-1), whole.argmax(-1))
                got16, whole16 = logits[torch.bfloat16]
                agree = float((got16.argmax(-1) == whole16.argmax(-1)).float().mean())
                print(f"[space] {name} weights, bands of {[b - a for a, b in bounds]} rows: f32 "
                      f"(TF32 off) max |dlogit| {err:.3e} of the largest |logit| (bound "
                      f"{SPACE_LOGIT_RTOL}), identical argmax {same} | bf16 argmax agreement "
                      f"with the unbanded bf16 {agree:.7f} (bound {SPACE_BF16_AGREEMENT})")
                self.check(err <= SPACE_LOGIT_RTOL and same, "banded f32 logits differ")
                self.check(agree >= SPACE_BF16_AGREEMENT, f"banded bf16 agreement {agree}")
        self._space_stencils()
        meshes = {"1x2": make_mesh(devices=[dev] * 2, space=2),
                  "2x2": make_mesh(devices=[dev] * 4, space=2)}
        pred = self._space_inferer(meshes)
        self._space_cleanup(meshes["2x2"], pred)
        self._space_train(meshes["1x2"])

    def _space_profile(self, fn, what: str, runs: int = 3):
        """``torch.profiler`` over ``runs`` calls of a forward: its device
        time (the kernels' summed durations) and kernels per call, and the
        operators with the most kernel time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        kernels = [e for e in prof.events() if e.device_type == cuda]
        device_ms = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3 / runs
        ops = sorted((e for e in prof.key_averages()
                      if e.device_type == cpu and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
        top = "; ".join(f"{e.key} {e.self_device_time_total / 1e3 / runs:.3f} ms x"
                        f"{e.count // runs}" for e in ops[:5])
        print(f"[space] profile of one chunk's forward, random weights, {what}: device "
              f"{device_ms:.3f} ms in {len(kernels) // runs} kernels per forward | operators by "
              f"their kernels' time: {top or 'no device events recorded'}")

    def _space_stencils(self):
        """K2 and K2ᵀ at the bands' shapes, K3 and K3ᵀ at the padded bands'
        (one or two halo rows) of every level, in a 32-slice chunk and a
        train step of batch 8, bf16 and f32: bit-equal to their plain
        versions; and K3 on each padded band, cropped, bit-equal to the
        whole height's rows."""
        torch = self.torch
        from lungmask_tpu_torch.ops.kernels import stencil as st
        from lungmask_tpu_torch.parallel.halo import Bands

        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(2)
        checked = 0
        for dtype in (torch.bfloat16, torch.float32):
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32

            def same(a, b):
                return torch.equal(a.view(bits), b.view(bits))

            for b in (CHUNK, TRAIN_BATCH):
                for _, h, w, c in POOL_SHAPES:
                    x = torch.randn((b, h // 2, w, c), generator=gen, device=dev).to(dtype)
                    g = torch.randn((b, h // 4, w // 2, c), generator=gen, device=dev).to(dtype)
                    self.check(same(st.avg_pool2(x), st.avg_pool2_reference(x)),
                               f"K2 differs at the band shape {tuple(x.shape)} {dtype}")
                    self.check(same(st.avg_pool2_bwd(g, x.shape),
                                    st.avg_pool2_bwd_reference(g, x.shape)),
                               f"K2ᵀ differs at the band shape {tuple(x.shape)} {dtype}")
                    checked += 2
                for _, h, w, c in UP_SHAPES:
                    for pad in (1, 2):
                        x = torch.randn((b, h // 2 + pad, w, c), generator=gen, device=dev)
                        x = x.to(dtype)
                        g = torch.randn((b, 2 * x.shape[1], 2 * w, c), generator=gen, device=dev)
                        g = g.to(dtype)
                        g[:, -2:] = 0  # the cropped rows' gradient
                        if pad == 2:
                            g[:, :2] = 0
                        self.check(same(st.bilinear_up2(x), st.bilinear_up2_reference(x)),
                                   f"K3 differs at the padded band {tuple(x.shape)} {dtype}")
                        self.check(same(st.bilinear_up2_bwd(g), st.bilinear_up2_bwd_reference(g)),
                                   f"K3ᵀ differs at the padded band {tuple(x.shape)} {dtype}")
                        checked += 2
            for _, h, w, c in UP_SHAPES:
                x = torch.randn((CHUNK, h, w, c), generator=gen, device=dev).to(dtype)
                for space in (2, 4):
                    rows = h // space
                    bands = Bands([x[:, i * rows : (i + 1) * rows] for i in range(space)])
                    up = bands.halo(st.bilinear_up2, rows=1, zeros=False, crop=2)
                    self.check(same(torch.cat(up.parts, dim=1), st.bilinear_up2(x)),
                               f"K3 on {space} padded bands of {tuple(x.shape)} differs")
                    checked += 1
        print(f"[space] K2/K2ᵀ at the bands' shapes, K3/K3ᵀ at the padded bands' (h/2 + 1 and "
              f"h/2 + 2 rows, e.g. {[(CHUNK, h // 2 + 1, w, c) for _, h, w, c in UP_SHAPES]}), "
              f"batch {CHUNK} and {TRAIN_BATCH}, bf16 and f32, and K3 on 2 and 4 padded bands "
              f"cropped against the whole height: {checked} checks, all bit-equal")

    def _space_inferer(self, meshes):
        """``LMInferer(mesh=)`` over both meshes (sharded preprocessing), single
        and fused, exact and device, against the unsharded device-mode
        inferer; one f32 model too. Returns the unsharded class map of the
        phantom (device mode) for the cleanup."""
        import numpy as np

        from lungmask_tpu_torch import LMInferer

        from lungmask_tpu_torch.parallel.mesh import split_rows

        vol = self.state["phantom"]
        pred = None
        for fused in (False, True):
            kw = (dict(modelname="LTRCLobes", fillmodel="R231") if fused
                  else dict(modelpath=self.state["weights"]))
            models = 2 if fused else 1
            for post in ("exact", "device"):
                ref_inf = LMInferer(tqdm_disable=True, preprocessing="device",
                                    postprocessing_mode=post, **kw)
                ref = ref_inf.apply(vol)
                if not fused and post == "device":
                    pred = ref_inf.forward_preprocessed(ref_inf.preprocess_image(vol))
                for mname, mesh in meshes.items():
                    inf = LMInferer(tqdm_disable=True, mesh=mesh, postprocessing_mode=post, **kw)
                    inf.apply(vol[:CHUNK])  # warm-up
                    _reset_launches()
                    t0 = time.perf_counter()
                    mask = inf.apply(vol)
                    wall = time.perf_counter() - t0
                    launches = _launches(FORWARD + BACKWARD)
                    # Each data row runs its slab in chunks of 32, each chunk as 2 bands.
                    chunks = sum(-(-(b - a) // CHUNK)
                                 for a, b in split_rows(len(vol), mesh.shape["data"]))
                    want = {"bodymask_labels": mesh.shape["data"],
                            "avg_pool2": 4 * chunks * models * 2,
                            "bilinear_up2": 4 * chunks * models * 2,
                            "avg_pool2_bwd": 0, "bilinear_up2_bwd": 0}
                    differ = int((mask != ref).sum())
                    print(f"[space] {mname} mesh {'fused' if fused else 'single'} {post}, bf16: "
                          f"apply {wall:.4f} s | launches {launches} | voxels differing from "
                          f"the unsharded preprocessing='device' mask: {differ} of {ref.size}")
                    self.check(differ == 0 or differ < SPACE_VOXEL_SHARE * ref.size,
                               f"{mname} {post}: {differ} voxels differ")
                    self.check(launches == want, f"launches {launches}, expected {want}")
        kw = dict(modelpath=self.state["weights"], tqdm_disable=True, precision="float32")
        ref = LMInferer(preprocessing="device", **kw).apply(vol)
        for mname, mesh in meshes.items():
            t0 = time.perf_counter()
            mask = LMInferer(mesh=mesh, **kw).apply(vol)
            differ = int((mask != ref).sum())
            print(f"[space] {mname} mesh single exact, f32 model: {time.perf_counter() - t0:.4f} s "
                  f"(first call) | voxels differing from the unsharded f32 mask: {differ}")
            self.check(differ == 0, f"{mname} f32: {differ} voxels differ")
        return pred

    def _space_cleanup(self, mesh, pred):
        """``make_sharded_postprocess`` of the phantom's class map on the 2x2
        mesh's blocks against ``postprocess_device``."""
        torch = self.torch
        from lungmask_tpu_torch.parallel import make_sharded_postprocess
        from lungmask_tpu_torch.parallel.mesh import shard_blocks
        from lungmask_tpu_torch.transforms.postprocess_device import postprocess_device

        step = make_sharded_postprocess(mesh, 3)
        blocks = shard_blocks(mesh, pred)
        single = postprocess_device(pred, 3)
        step(blocks)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = step(blocks)
        torch.cuda.synchronize()
        t_banded = time.perf_counter() - t0
        t0 = time.perf_counter()
        postprocess_device(pred, 3)
        torch.cuda.synchronize()
        t_single = time.perf_counter() - t0
        whole = torch.cat([torch.cat(row, dim=1) for row in got])
        same = torch.equal(whole, single)
        print(f"[space] make_sharded_postprocess of one {tuple(pred.shape)} class map over the "
              f"2x2 mesh's blocks {[[tuple(b.shape) for b in row] for row in blocks]}: "
              f"{t_banded:.4f} s against postprocess_device {t_single:.4f} s | bit-equal {same}")
        self.check(same and all(b.is_cuda for row in got for b in row),
                   "the banded cleanup differs")

    def _space_train(self, mesh):
        """``fit(mesh=1x2)`` beside the unsharded fit (bf16, 4 steps of batch
        8) and one f32 step's loss and gradients against the unsharded
        step's."""
        import numpy as np

        torch = self.torch
        from lungmask_tpu_torch.models import unet
        from lungmask_tpu_torch.train import default_optimizer, fit, init_train_state
        from lungmask_tpu_torch.train import make_train_step
        from lungmask_tpu_torch.train.data import SliceDataset

        dev = torch.device("cuda", 0)
        vol, mask = self.state["phantom"], self.state["mask"]
        ds = SliceDataset([(vol[:MESH_TRAIN_SLICES], mask[:MESH_TRAIN_SLICES])], device=dev)
        params = unet.init_params(3, generator=torch.Generator().manual_seed(0))
        steps = MESH_TRAIN_SLICES // TRAIN_BATCH
        kw = dict(batch_size=TRAIN_BATCH, optimizer=default_optimizer(steps, peak_lr=TRAIN_PEAK_LR),
                  seed=0, log_every=1, compute_dtype=torch.bfloat16)
        runs = {}
        for name, extra in (("unsharded", dict(device=dev)), ("1x2", dict(mesh=mesh))):
            _reset_launches()
            t0 = time.perf_counter()
            res = fit(params, ds, **kw, **extra)
            torch.cuda.synchronize()
            runs[name] = ([h["loss"] for h in res.history if "loss" in h],
                          time.perf_counter() - t0, _launches(FORWARD + BACKWARD))
        losses, wall, launches = runs["1x2"]
        ref = runs["unsharded"][0]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        want = {"bodymask_labels": 0, "avg_pool2": 8 * steps, "bilinear_up2": 8 * steps,
                "avg_pool2_bwd": 8 * steps, "bilinear_up2_bwd": 8 * steps}
        print(f"[space] fit(mesh=1x2), {steps} bf16 steps of batch {TRAIN_BATCH} (2 bands of 128 "
              f"rows, wf=6): {wall:.4f} s | launches {launches} "
              f"(K2/K3/K2ᵀ/K3ᵀ 8/8/8/8 per step) "
              f"| losses " + ", ".join(f"{v:.6f}" for v in losses) + " | unsharded fit: "
              + ", ".join(f"{v:.6f}" for v in ref) + f" in {runs['unsharded'][1]:.4f} s | "
              f"largest relative difference {rel:.3e} (bound {SPACE_LOSS_RTOL})")
        self.check(launches == want, f"fit(mesh=1x2) launches {launches}, expected {want}")
        self.check(len(losses) == steps and rel <= SPACE_LOSS_RTOL, f"losses {losses} vs {ref}")

        class Recorder:  # keeps the step's gradients, moves no weight
            def init(self, params):
                return None

            def update(self, grads, state, params):
                self.grads = {k: g.clone() for k, g in grads.items()}
                return {k: torch.zeros_like(g) for k, g in grads.items()}, state

        im, lb = next(ds.batches(TRAIN_BATCH, seed=0))

        def grads(mesh_):
            rec = Recorder()
            state = init_train_state(params, rec, dev)
            _, loss = make_train_step(rec, mesh=mesh_, compute_dtype=torch.float32)(state, im, lb)
            return float(loss), rec.grads

        l_ref, g_ref = grads(None)
        l_band, g_band = grads(mesh)
        worst = max(float((g_band[k] - g).abs().max() / g.abs().max()) for k, g in g_ref.items())
        print(f"[space] one f32 step (batch {TRAIN_BATCH}, wf=6) over the 1x2 mesh: loss "
              f"{l_band:.7f} vs unsharded {l_ref:.7f} | worst gradient leaf difference "
              f"{worst:.3e} of its largest (bound {SPACE_GRAD_RTOL})")
        self.check(abs(l_band - l_ref) <= 1e-5 * abs(l_ref), "the banded f32 loss differs")
        self.check(worst <= SPACE_GRAD_RTOL, f"the banded f32 gradients differ by {worst}")

        state = init_train_state(params, kw["optimizer"], dev)
        step_fn = make_train_step(kw["optimizer"], mesh=mesh, compute_dtype=torch.bfloat16)
        x, y = torch.as_tensor(im).to(dev), torch.as_tensor(lb).to(dev)
        state, _ = step_fn(state, x, y)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step_fn(state, x, y)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        print(f"[space] banded train step (1x2 on one card, batch {TRAIN_BATCH}, bf16): median "
              f"{float(np.median(times)):.3f} ms of 5 (range {min(times):.3f}-{max(times):.3f}) "
              f"({self.state['smi']})")

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import lungmask_tpu_torch  # noqa: F401
    except ImportError as e:  # the script alone, outside a checkout of the repository
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1

    smoke = Smoke(torch)
    with tempfile.TemporaryDirectory(prefix="lungmask_smoke_") as tmp:
        smoke.state["tmp"] = tmp
        # What each phase needs from an earlier one: state key → its maker.
        needs = {
            "unet": {"phantom": "kernel"},
            "fused": {"phantom": "kernel"},
            "inferer": {"phantom": "kernel", "params": "unet"},
            "cli": {"phantom": "kernel", "params": "unet", "inferer": "inferer"},
            "dicom": {"phantom": "kernel", "inferer": "inferer", "smi": "device"},
            "postdev": {"phantom": "kernel", "inferer": "inferer", "fused_mask": "fused"},
            "cohort": {"phantom": "kernel", "inferer": "inferer", "dev_inferer": "postdev"},
            "serve": {"phantom": "kernel", "inferer": "inferer"},
            "devprep": {"phantom": "kernel", "inferer": "inferer", "mask": "inferer",
                        "smi": "device"},
            "train": {"phantom": "kernel", "mask": "inferer", "smi": "device"},
            "variants": {"phantom": "kernel", "smi": "device"},
            "mesh": {"phantom": "kernel", "mask": "inferer", "weights": "inferer",
                     "cache": "fused", "smi": "device"},
            "space": {"phantom": "kernel", "params": "unet", "mask": "inferer",
                      "weights": "inferer", "cache": "fused", "smi": "device"},
        }
        for name in ("device", "build", "kernel", "unet", "stencil", "fused", "inferer", "cli",
                     "dicom", "postdev", "cohort", "serve", "devprep", "train", "variants",
                     "mesh", "space"):
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
    measured = {"bodymask_labels": smoke.state["k1"], **smoke.state["stencil"],
                **smoke.state["adjoints"]}
    launches = {**smoke.state["launches"], **{k: smoke.state["train_launches"][k]
                                              for k in BACKWARD}}
    sources = {
        "bodymask_labels": (K1_SOURCE, K1_REPLACES),
        "avg_pool2": (STENCIL_SOURCE, K2_REPLACES),
        "bilinear_up2": (STENCIL_SOURCE, K3_REPLACES),
        "avg_pool2_bwd": (STENCIL_SOURCE, K2T_REPLACES),
        "bilinear_up2_bwd": (STENCIL_SOURCE, K3T_REPLACES),
    }
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
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
