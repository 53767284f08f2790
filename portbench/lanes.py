"""The three ways a cell drives the port, chosen by the traffic file's
``lane``: ``apply`` (a closed loop of ``LMInferer.apply`` calls),
``finetune`` (``train.loop.fit``) and ``cohort``
(``runtime.cohort.run_cohort`` over DICOM series). Each lane makes its
inputs and weights from the seed, warms up the shapes its traffic uses,
measures for the window, reads the device's memory peak, frees the
program's state, and then checks a sample of what the window produced
against the reference. Everything that depends on the model comes from
the configuration's family (``portbench/families/<name>.py``, found by
``spec.family``), so a new family runs under these lanes unchanged; a lane
that is not one of :data:`LANES` is a file of its own,
``portbench/lanes_extra/<lane>.py`` with a function ``run(run)``
(:func:`resolve`).

A lane returns a dict: ``attempted``, ``failed``, ``e2e`` (end-to-end
values), ``ctx`` (what the per-layer readers read), ``checks`` ([name,
value, limit]), ``memory_peak_bytes`` and ``trace`` (the reduced trace of
a traced run, else None).
"""

from __future__ import annotations

import gzip
import os
import shutil
import statistics
import struct
import sys
import tempfile
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench import phantom, spec, tracing


class Run:
    """One run of one cell: its arguments, parts and scratch directory."""

    def __init__(self, args, cell: dict, device: torch.device, t_start: float):
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.cell = cell
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.limits = cell["limits"]
        self.family = spec.family(self.config)
        self.device = device
        self.t_start = t_start
        self.setup_s = None
        self.phases: List[list] = []  # [name, seconds since the previous mark]
        self._last = t_start
        self.tmp = tempfile.mkdtemp(prefix="portbench-")
        self.rng = np.random.default_rng([self.seed % 2**63, 7])
        self.look = False  # calibration: also read what is not compared, into ``looked``
        self.looked: Dict[str, float] = {}

    @property
    def window_seconds(self) -> float:
        """The measured window: ``--seconds``, or in a traced run the
        traffic's ``trace_seconds`` where that is shorter."""
        if self.trace:
            return min(self.seconds, float(self.traffic.get("trace_seconds", self.seconds)))
        return self.seconds

    def mark(self, phase: str) -> None:
        """Close a phase of set-up (reported on standard error)."""
        self.sync()
        now = time.perf_counter()
        self.phases.append([phase, now - self._last])
        self._last = now

    def setup_done(self) -> None:
        self.mark("warm-up")
        self.setup_s = time.perf_counter() - self.t_start

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free_device(self) -> None:
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def limit(self, name: str) -> float:
        return float(self.limits[name])

    def cleanup(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def _images(run: Run):
    """The traffic's pool of seeded volumes as ``MedicalImage``s in RAS
    orientation, as NIfTI files from most scanners carry."""
    from lungmask_tpu_torch.io.image import MedicalImage

    tr = run.traffic
    vols = phantom.pool(run.seed, tr["pool"], tr["slices"], tr["size"], run.device)
    return [MedicalImage(v, spacing=tuple(tr["spacing"]), direction=phantom.RAS) for v, _ in vols]


def _sampled(run: Run, called: List[int]) -> List[int]:
    k = min(int(run.traffic.get("check_pool", 1)), len(called))
    return sorted(int(i) for i in run.rng.choice(sorted(called), size=k, replace=False))


def _keep(kept: Dict[int, List[np.ndarray]], i: int, mask: np.ndarray) -> None:
    """The first and the latest mask of pool volume ``i``."""
    slot = kept.setdefault(i, [])
    if len(slot) < 2:
        slot.append(mask)
    else:
        slot[1] = mask


def _stage_ctx(run: Run, timings, n_done: int, window: float, image) -> dict:
    cost = run.family.forward_cost(run.config, image.array.shape, image.spacing)
    return {"volumes": n_done, "window_s": window,
            "stage_totals": dict(timings.totals),
            "forward_flops": cost["flops"] * n_done, "forward_bound_s": cost["bound_s"] * n_done}


def lane_apply(run: Run) -> dict:
    """A closed loop with one client: ``apply`` on the pool in turn, each
    mask dropped on return. A traced run drives the same stages through the
    split-phase API, each in a benchmark span."""
    fam = run.family
    run.mark("start")
    trees = fam.weights(run)
    run.mark("weights")
    images = _images(run)
    run.mark("inputs")
    inferer = fam.inferer(run, trees)
    run.mark("inferer")
    shapes = {}
    for i, img in enumerate(images):
        shapes.setdefault(img.array.shape, i)
    for _ in range(int(run.traffic.get("warm_calls", 1))):
        for i in shapes.values():
            inferer.apply(images[i])
    inferer.timings.reset()
    run.setup_done()

    def call(img):
        if not run.trace:
            return inferer.apply(img)
        with tracing.span("preprocess"):
            pre = inferer.preprocess_image(img)
        with tracing.span("forward"):
            pred = inferer.forward_preprocessed(pre)
        with tracing.span("finish"):
            return inferer.finish_forward(pre, pred)

    latencies, kept, failed, k = [], {}, 0, 0
    with tracing.profiled(run.trace) as trace:
        t0 = time.perf_counter()
        end = t0 + run.window_seconds
        while True:
            i = k % len(images)
            ts = time.perf_counter()
            if ts >= end:
                break
            try:
                mask = call(images[i])
            except Exception as e:  # a failed call counts, the loop goes on
                print(f"portbench: apply failed: {e!r}", file=sys.stderr)
                failed += 1
                mask = None
            te = time.perf_counter()
            latencies.append(te - ts)
            if mask is not None:
                _keep(kept, i, mask)
            k += 1
        t_end = time.perf_counter()
    window = t_end - t0
    done = k - failed
    ctx = _stage_ctx(run, inferer.timings, done, window, images[0])
    sampled = _sampled(run, sorted(kept))
    prog = fam.outputs(run, inferer, images, sampled)
    peak = run.memory_peak()
    del inferer
    run.free_device()
    checks = fam.checks(run, {i: kept[i] for i in sampled}, prog, images, trees)
    p90 = (statistics.quantiles(latencies, n=10, method="inclusive")[8] if len(latencies) > 1
           else latencies[0])
    return {
        "attempted": k, "failed": failed,
        "e2e": {"volumes_per_h": 3600.0 * done / window, "volume_p90_s": p90},
        "ctx": ctx, "checks": checks, "memory_peak_bytes": peak, "trace": trace or None,
    }


# -- cohort -------------------------------------------------------------------


def read_nifti(path: str) -> np.ndarray:
    """A little-endian uint8 NIfTI-1 mask (``.nii.gz``) as (z, y, x)."""
    with gzip.open(path, "rb") as f:
        data = f.read()
    dims = struct.unpack_from("<8h", data, 40)
    if struct.unpack_from("<h", data, 70)[0] != 2:
        raise ValueError(f"{path}: not a uint8 mask")
    offset = int(struct.unpack_from("<f", data, 108)[0])
    nx, ny, nz = dims[1], dims[2], dims[3]
    return np.frombuffer(data, np.uint8, count=nx * ny * nz, offset=offset).reshape(nz, ny, nx)


def lane_cohort(run: Run) -> dict:
    """``run_cohort`` over DICOM series directories written once at set-up,
    listed over and over; each mask is written as ``.nii.gz`` and deleted
    once counted."""
    from lungmask_tpu_torch.io import loader
    from lungmask_tpu_torch.runtime.cohort import run_cohort

    tr, fam = run.traffic, run.family
    run.mark("start")
    trees = fam.weights(run)
    run.mark("weights")
    images = _images(run)
    dirs = []
    for i, img in enumerate(images):
        d = os.path.join(run.tmp, "series", f"s{i}")
        os.makedirs(d)
        loader.write_dicom_series(img, os.path.join(d, "ct.dcm"))
        dirs.append(d)
    run.mark("inputs")
    out_dir, keep_dir = os.path.join(run.tmp, "out"), os.path.join(run.tmp, "kept")
    os.makedirs(out_dir)
    os.makedirs(keep_dir)
    inferer = fam.inferer(run, trees)
    run.mark("inferer")
    prefetch = int(tr.get("prefetch", 2))

    def drop(res):
        path = os.path.join(out_dir, f"{res.name}_mask.nii.gz")
        if os.path.exists(path):
            os.remove(path)

    run_cohort(dirs[: int(tr.get("warm_volumes", 1))], inferer, output_dir=out_dir,
               prefetch=prefetch, on_result=drop)
    inferer.timings.reset()
    run.setup_done()

    kept, state = {}, {"n": 0}
    end = 0.0

    def sources():
        k = 0
        while time.perf_counter() < end:
            yield dirs[k % len(dirs)]
            k += 1

    def on_result(res):
        j = state["n"]
        state["n"] += 1
        if res.error is not None:
            return
        path = os.path.join(out_dir, f"{res.name}_mask.nii.gz")
        i = j % len(dirs)
        slot = kept.setdefault(i, [])
        if len(slot) < 2:
            target = os.path.join(keep_dir, f"{i}_{len(slot)}.nii.gz")
            slot.append(target)
        else:
            target = slot[1]
        os.replace(path, target)

    with tracing.profiled(run.trace) as trace:
        t0 = time.perf_counter()
        end = t0 + run.window_seconds
        stats = run_cohort(sources(), inferer, output_dir=out_dir, prefetch=prefetch,
                           on_result=on_result)
        t_end = time.perf_counter()
    window = t_end - t0
    attempted = len(stats.results)
    failed = sum(1 for r in stats.results if r.error is not None)
    done = attempted - failed
    ctx = _stage_ctx(run, inferer.timings, done, window, images[0])
    ctx["cohort_stage_seconds"] = dict(stats.stage_seconds)
    ctx["cohort_wall_s"] = stats.wall_seconds
    sampled = _sampled(run, sorted(kept))
    prog = fam.outputs(run, inferer, images, sampled)
    peak = run.memory_peak()
    del inferer
    run.free_device()
    masks = {i: [read_nifti(p) for p in kept[i]] for i in sampled}
    checks = fam.checks(run, masks, prog, images, trees)
    return {
        "attempted": attempted, "failed": failed,
        "e2e": {"volumes_per_h": 3600.0 * done / window},
        "ctx": ctx, "checks": checks, "memory_peak_bytes": peak, "trace": trace or None,
    }


# -- fine-tuning --------------------------------------------------------------


FIT_LOCALS = ("loss", "state")
TRAIN_PIECES = ("train_model", "train_readings", "train_checks", "train_flops")


def _fit_locals(frame) -> dict:
    """The locals of ``train.loop.fit``'s loop, which resumed the batch
    iterator: after step k its ``loss`` and ``state`` are step k's. The
    port has no per-step hook yet; a ``fit`` whose loop no longer holds
    these names stops the run here, by name."""
    found = frame.f_locals
    missing = [n for n in FIT_LOCALS if n not in found]
    if frame.f_code.co_name != "fit" or missing:
        raise RuntimeError(
            f"portbench: the batch iterator was resumed by {frame.f_code.co_name!r}, whose locals "
            f"lack {missing or list(FIT_LOCALS)}: train.loop.fit's loop must hold the step's "
            "'loss' and 'state' for the fine-tuning check")
    return found


def lane_finetune(run: Run) -> dict:
    """``fit`` on a ``SliceDataset`` of seeded phantom slices with lung
    labels, ``Augmenter(lr_swap)``, batch, bf16 and Dice weight from the
    traffic; evaluation and checkpoints off. One ``fit`` call runs the whole
    run: its first steps and the warm-up are set-up; the dataset's batch
    iterator opens the window after ``warm_steps`` and ends the epoch when it
    closes. The three steps checked against the reference are steps 1-3 of
    that call, before the window opens (:func:`_fit_locals`). The model,
    the program's readings and the reference come from the family's
    ``train_*`` pieces; a family without them stops the run."""
    from lungmask_tpu_torch.train.augment import Augmenter
    from lungmask_tpu_torch.train.data import SliceDataset
    from lungmask_tpu_torch.train.loop import fit
    from lungmask_tpu_torch.train.optim import default_optimizer

    fam = run.family
    missing = [n for n in TRAIN_PIECES if not hasattr(fam, n)]
    if missing:
        raise RuntimeError(f"portbench: family {fam.__file__} gives no training step (no "
                           f"{', '.join(missing)}); the finetune lane cannot run it")
    tr = run.traffic
    batch, warm = int(tr["batch"]), int(tr["warm_steps"])
    run.mark("start")
    tree = fam.weights(run)[0]
    run.mark("weights")
    pairs = phantom.pool(run.seed, tr["volumes"], tr["slices"], tr["size"], run.device)
    obs: dict = {"loss": {}}
    trace_cm = tracing.profiled(run.trace)
    marks = {}

    class Windowed(SliceDataset):
        def batches(self, batch_size, *, seed=0, epochs=1, drop_last=True):
            it = super().batches(batch_size, seed=seed, epochs=epochs, drop_last=drop_last)
            k = 0
            step_span = None
            for item in it:
                if step_span is not None:
                    step_span.__exit__(None, None, None)
                    step_span = None
                if 1 <= k <= 3:
                    caller = _fit_locals(sys._getframe(1))
                    obs["loss"][k] = caller["loss"]
                    if k == 1:
                        obs["state1"] = caller["state"]
                    if k == 3:
                        obs["params3"] = {n: p.detach().clone()
                                          for n, p in caller["state"].model.named_parameters()}
                if k == warm:
                    run.setup_done()
                    marks["trace"] = trace_cm.__enter__()
                    marks["t0"] = time.perf_counter()
                    marks["end"] = marks["t0"] + run.window_seconds
                elif k > warm and time.perf_counter() >= marks["end"]:
                    run.sync()
                    break
                if run.trace and k >= warm:
                    step_span = tracing.span("step")
                    step_span.__enter__()
                yield item
                k += 1
            marks["t_end"] = time.perf_counter()
            marks["steps"] = k - warm
            if step_span is not None:
                step_span.__exit__(None, None, None)
            trace_cm.__exit__(None, None, None)

    dataset = Windowed(pairs, resolution=(run.config["resolution"],) * 2, device=run.device)
    run.mark("inputs")
    n_batches = (len(dataset) // batch) * int(tr["epochs"])
    augment = Augmenter(lr_swap=tuple(tr["lr_swap"]))
    if run.trace:
        plain = augment

        def augment(images, labels, rng):
            with tracing.span("augment"):
                return plain(images, labels, rng)

    fit_seed = int(run.rng.integers(0, 2**31))
    compute = {"bfloat16": torch.bfloat16, "float32": torch.float32}[run.config["precision"]]
    fit(fam.train_model(run, tree), dataset,
        epochs=int(tr["epochs"]), batch_size=batch, optimizer=default_optimizer(n_batches),
        augment=augment, seed=fit_seed, compute_dtype=compute,
        dice_weight=float(tr["dice_weight"]), device=run.device)
    window = marks["t_end"] - marks["t0"]
    steps = marks["steps"]
    peak = run.memory_peak()

    prog = fam.train_readings(tree, obs["state1"], obs["params3"])
    prog["loss"] = [float(obs["loss"][k]) for k in (1, 2, 3)]
    del obs
    run.free_device()
    checks = fam.train_checks(run, pairs, tree, prog, fit_seed=fit_seed, n_batches=n_batches)
    slices = steps * batch
    ctx = {"window_s": window, "steps": steps, "slices": slices,
           "train_flops": fam.train_flops(run.config, slices)}
    return {
        "attempted": steps, "failed": 0,
        "e2e": {"train_slices_per_s": slices / window},
        "ctx": ctx, "checks": checks, "memory_peak_bytes": peak,
        "trace": marks.get("trace") or None,
    }


LANES: Dict[str, Callable[[Run], dict]] = {
    "apply": lane_apply,
    "cohort": lane_cohort,
    "finetune": lane_finetune,
}


def resolve(lane: str) -> Callable[[Run], dict]:
    """The lane a traffic file names: one of :data:`LANES`, else the
    function ``run`` of ``portbench/lanes_extra/<lane>.py``; a lane with
    neither stops the run, naming the file it looked for."""
    if lane in LANES:
        return LANES[lane]
    return spec.module("lanes_extra", lane).run
