"""The three ways a cell drives the port, chosen by the traffic file's
``lane``: ``apply`` (a closed loop of ``LMInferer.apply`` calls),
``finetune`` (``train.loop.fit``) and ``cohort``
(``runtime.cohort.run_cohort`` over DICOM series). Each lane makes its
inputs and weights from the seed, warms up the shapes its traffic uses,
measures for the window, reads the device's memory peak, frees the
program's state, and then checks a sample of what the window produced
against the reference (``portbench/reference``).

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

from portbench import phantom, roofline, tracing, weights

B1 = 0.9  # Adam's first-moment decay (optax's default, the port's AdamW)


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

    def model_trees(self) -> List[Dict[str, np.ndarray]]:
        c = self.config
        return [weights.make(self.seed, i, depth=c["depth"], wf=c["wf"], n_classes=m["n_classes"],
                             eps=c["perturbation"], eps_head=c["head_perturbation"],
                             device=self.device)
                for i, m in enumerate(c["models"])]

    def forward_cost(self, n_slices: int) -> dict:
        """Analytic work and bound of one volume's forward(s) (every model
        of the configuration)."""
        c = self.config
        costs = [roofline.forward_cost(n_slices, c["chunk"], depth=c["depth"], wf=c["wf"],
                                       size=c["resolution"], n_classes=m["n_classes"])
                 for m in c["models"]]
        return {"flops": sum(x["flops"] for x in costs), "bound_s": sum(x["bound_s"] for x in costs)}

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


def _inferer(run: Run, trees):
    from lungmask_tpu_torch.inferer import LMInferer

    paths = [weights.save_npz(os.path.join(run.tmp, f"model{i}.npz"), t) for i, t in enumerate(trees)]
    kwargs = dict(run.traffic.get("inferer", {}))
    if run.device.type == "cpu":
        kwargs["force_cpu"] = True
    return LMInferer(modelpath=paths[0], fillmodel_path=paths[1] if len(paths) > 1 else None,
                     tqdm_disable=True, batch_size=run.config["chunk"], **kwargs)


def _program_maps(inferer, image):
    """``image`` once more through the timed inferer's first two split
    phases (the stages ``apply`` runs): its class map(s) as the host
    receives them, and its boxes."""
    pre = inferer.preprocess_image(image)
    pred = inferer.forward_preprocessed(pre)
    maps = pred if isinstance(pred, tuple) else (pred,)
    return [np.asarray(m) for m in maps], np.asarray(pre["boxes"])


def _chunk_logits(run: Run, inferer, images, i: int):
    """One chunk of pool volume ``i``, drawn from the seed: the reference's
    normalized slices of it, and the class scores that each of the timed
    inferer's runners (its U-Net on the window's kernels, at the window's
    chunk size) gives those slices, float32 (n, H, W, K) on the host."""
    from portbench.reference import pipeline

    n, chunk = images[i].array.shape[0], int(run.config["chunk"])
    start = chunk * int(run.rng.integers(0, -(-n // chunk)))
    x = pipeline.normalized_slices(images[i].array, images[i].direction, start, start + chunk,
                                   run.config["resolution"])
    runners = [r for r in (inferer.model, inferer.fillmodelm) if r is not None]
    with torch.inference_mode():
        xt = torch.as_tensor(x, dtype=torch.float32, device=run.device).unsqueeze(-1)
        return x, [r.model(xt).float().cpu() for r in runners]


def _logit_gap(run: Run, x: np.ndarray, got: List[torch.Tensor], trees) -> float:
    """The worst class's gap (``reference.unet.class_gap``: the norm of the
    difference over the scale of the head's terms) between the program's
    class scores and the float32 reference U-Net's, over the
    configuration's models."""
    from portbench.reference import unet

    xt = torch.as_tensor(x, dtype=torch.float32, device=run.device)
    worst = 0.0
    for flat, scores in zip(trees, got):
        p = unet.tensors(flat, run.device)
        with torch.no_grad():
            want, scale = unet.scores(p, xt)
        worst = max(worst, unet.class_gap(scores, want.cpu(), scale))
        del p, want
    return worst


def _inference_checks(run: Run, masks, prog, chunk, images, trees) -> List[list]:
    """Each number beside its limit, over the sampled pool volumes
    (``masks``: the window's masks of each; ``prog``: what
    :func:`_program_maps` returned for it; ``chunk``: what
    :func:`_chunk_logits` returned, or None where the window returned no
    mask, which reads 1 throughout):

    - ``map_mismatch``: the largest share of pixels in which a program class
      map differs from the reference's (its own preprocessing and float32
      U-Net): preprocessing, the U-Net, its argmax and download;
    - ``finish_mismatch``: the largest share of voxels in which a mask of
      the window differs from the reference's postprocessing, paste-back,
      fusion and reorientation of the program's class maps and boxes
      (exact): the host stages after the U-Net;
    - ``logit_gap``: the chunk's class scores (:func:`_logit_gap`).
    """
    from portbench.reference import pipeline

    map_mm = fin_mm = 0.0 if masks else 1.0
    for i, kept in sorted(masks.items()):
        img = images[i]
        ref_maps, ref_boxes, shape = pipeline.class_maps(img.array, img.direction, trees,
                                                         run.device)
        maps, boxes = prog[i]
        for got, want in zip(maps, ref_maps):
            map_mm = max(map_mm, float(np.mean(got != want)) if got.shape == want.shape else 1.0)
        want = pipeline.finish(maps, boxes, shape, img.direction)
        for m in kept:
            fin_mm = max(fin_mm, float(np.mean(m != want)) if m.shape == want.shape else 1.0)
        if run.look:  # the whole pipeline's mask against the window's (calibration only)
            ref = pipeline.finish(ref_maps, ref_boxes, shape, img.direction)
            run.looked["mask_mismatch"] = max([run.looked.get("mask_mismatch", 0.0)]
                                              + [float(np.mean(m != ref)) for m in kept])
    gap = _logit_gap(run, chunk[0], chunk[1], trees) if chunk is not None else 1.0
    return [["map_mismatch", map_mm, run.limit("map_mismatch")],
            ["finish_mismatch", fin_mm, run.limit("finish_mismatch")],
            ["logit_gap", gap, run.limit("logit_gap")]]


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


def _stage_ctx(run: Run, timings, n_done: int, window: float, n_slices: int) -> dict:
    cost = run.forward_cost(n_slices)
    return {"volumes": n_done, "window_s": window,
            "stage_totals": dict(timings.totals),
            "forward_flops": cost["flops"] * n_done, "forward_bound_s": cost["bound_s"] * n_done}


def lane_apply(run: Run) -> dict:
    """A closed loop with one client: ``apply`` on the pool in turn, each
    mask dropped on return. A traced run drives the same stages through the
    split-phase API, each in a benchmark span."""
    run.mark("start")
    trees = run.model_trees()
    run.mark("weights")
    images = _images(run)
    run.mark("inputs")
    inferer = _inferer(run, trees)
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
    n_slices = images[0].array.shape[0]
    ctx = _stage_ctx(run, inferer.timings, done, window, n_slices)
    sampled = _sampled(run, sorted(kept))
    chunk = _chunk_logits(run, inferer, images, sampled[0]) if sampled else None
    prog = {i: _program_maps(inferer, images[i]) for i in sampled}
    peak = run.memory_peak()
    del inferer
    run.free_device()
    checks = _inference_checks(run, {i: kept[i] for i in sampled}, prog, chunk, images, trees)
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

    tr = run.traffic
    run.mark("start")
    trees = run.model_trees()
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
    inferer = _inferer(run, trees)
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
    ctx = _stage_ctx(run, inferer.timings, done, window, images[0].array.shape[0])
    ctx["cohort_stage_seconds"] = dict(stats.stage_seconds)
    ctx["cohort_wall_s"] = stats.wall_seconds
    sampled = _sampled(run, sorted(kept))
    chunk = _chunk_logits(run, inferer, images, sampled[0]) if sampled else None
    prog = {i: _program_maps(inferer, images[i]) for i in sampled}
    peak = run.memory_peak()
    del inferer
    run.free_device()
    masks = {i: [read_nifti(p) for p in kept[i]] for i in sampled}
    checks = _inference_checks(run, masks, prog, chunk, images, trees)
    return {
        "attempted": attempted, "failed": failed,
        "e2e": {"volumes_per_h": 3600.0 * done / window},
        "ctx": ctx, "checks": checks, "memory_peak_bytes": peak, "trace": trace or None,
    }


# -- fine-tuning --------------------------------------------------------------


def flat_tree(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_tree(v, f"{prefix}.{i}"))
        return out
    return {prefix: tree}


FIT_LOCALS = ("loss", "state")


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
    that call, before the window opens (:func:`_fit_locals`)."""
    from lungmask_tpu_torch.models import convert
    from lungmask_tpu_torch.train.augment import Augmenter
    from lungmask_tpu_torch.train.data import SliceDataset
    from lungmask_tpu_torch.train.loop import fit
    from lungmask_tpu_torch.train.optim import default_optimizer

    tr = run.traffic
    batch, warm = int(tr["batch"]), int(tr["warm_steps"])
    run.mark("start")
    tree = run.model_trees()[0]
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
    fit(convert.from_jax_params(weights.nested(tree), run.device), dataset,
        epochs=int(tr["epochs"]), batch_size=batch, optimizer=default_optimizer(n_batches),
        augment=augment, seed=fit_seed, compute_dtype=compute,
        dice_weight=float(tr["dice_weight"]), device=run.device)
    window = marks["t_end"] - marks["t0"]
    steps = marks["steps"]
    peak = run.memory_peak()

    model = obs["state1"].model
    mu = obs["state1"].opt_state.mu
    prog_grad = {k: float(v.norm()) / (1.0 - B1)
                 for k, v in flat_tree(model.tree(of=mu)).items()}
    p3 = flat_tree(model.tree(of=obs["params3"]))
    prog_change = {}
    for k, v in tree.items():
        a = np.asarray(v, np.float32)
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
        prog_change[k] = float((p3[k].float().cpu() - torch.from_numpy(np.ascontiguousarray(a))).norm())
    prog_loss = [float(obs["loss"][k]) for k in (1, 2, 3)]
    del model, mu, p3, obs
    run.free_device()

    from portbench.reference import train as ref_train

    ref = ref_train.first_steps(pairs, tree, batch=batch, seed=fit_seed, n_batches=n_batches,
                                dice_weight=float(tr["dice_weight"]),
                                lr_swap=tuple(tr["lr_swap"]), size=run.config["resolution"],
                                device=run.device)
    gaps = ref_train.gaps({"loss": prog_loss, "grad": prog_grad, "change": prog_change}, ref)
    print(f"portbench: {gaps['left_out']} leaves left out of change_gap", file=sys.stderr)
    checks = [[name, gaps[name], run.limit(name)] for name in ("loss_gap", "grad_gap", "change_gap")]
    slices = steps * batch
    ctx = {"window_s": window, "steps": steps, "slices": slices,
           "train_flops": 3.0 * roofline.forward_cost(
               slices, slices, depth=run.config["depth"], wf=run.config["wf"],
               size=run.config["resolution"], n_classes=run.config["models"][0]["n_classes"])["flops"]}
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
