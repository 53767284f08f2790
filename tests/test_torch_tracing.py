"""The port's stage record as spans on the profiler's clock, the stages
that time reorientation, decode and the mask write, the benchmark's readers
of them, and the operator's trace of every thread.

* ``StageTimer.stage(name)`` keeps its totals and counts and is also the
  ``record_function`` span ``lungmask.<name>``, in the thread that ran it.
* ``LMInferer`` times ``to_lps`` and ``from_lps`` once per volume (twice
  ``from_lps`` in the fused pair); ``run_cohort`` times ``decode`` per
  source, failed ones included, and ``write`` per mask written.
* ``$LUNGMASK_TPU_TRACE_DIR``: one trace per fused ``apply`` and per
  ``run_cohort`` call, holding the spans of the threads they start; unset,
  no profiler is made.

Tolerance: none (counts, names and file contents are compared exactly).
"""

import glob
import json
import logging
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parity  # noqa: F401  (one torch thread per worker)
from lungmask_tpu_torch import LMInferer, cli
from lungmask_tpu_torch.io.image import MedicalImage
from lungmask_tpu_torch.logger import logger
from lungmask_tpu_torch.models import convert, synthetic
from lungmask_tpu_torch.runtime.cohort import run_cohort
from lungmask_tpu_torch.utils import profiling
from lungmask_tpu_torch.utils.profiling import StageTimer
from portbench import spec

KW = dict(device="cpu", precision="float32", tqdm_disable=True, batch_size=2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "laterality_wf2.npz")
    convert.save_npz(path, synthetic.laterality_params(wf=2))
    return path


@pytest.fixture(scope="module")
def phantom():
    return synthetic.lung_phantom(2, size=64)


def _ras(vol):
    return MedicalImage(vol, spacing=(0.7, 0.7, 2.5), direction=np.diag([-1.0, -1.0, 1.0]))


def _annotations(prof):
    """(name, start, end, thread) of every ``lungmask.`` span in a profile."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name().startswith(profiling.SPAN_PREFIX)]


def _trace_spans(trace_dir, name):
    """{span name: set of thread ids} of the one trace under ``<dir>/<name>/``."""
    files = glob.glob(os.path.join(trace_dir, name, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("lungmask."):
            out.setdefault(e["name"], set()).add(e["tid"])
    return out


# -- StageTimer ------------------------------------------------------------------


def test_stage_is_a_span_and_keeps_its_totals():
    timer = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("outer"):
            with timer.stage("inner"):
                torch.ones(4).sum()
        with timer.stage("inner"):
            pass
    spans = _annotations(prof)
    assert sorted(n for n, *_ in spans) == ["lungmask.inner", "lungmask.inner", "lungmask.outer"]
    (_, o0, o1, _), = [s for s in spans if s[0] == "lungmask.outer"]
    first_inner = min(s for s in spans if s[0] == "lungmask.inner")
    assert o0 <= first_inner[1] and first_inner[2] <= o1
    assert dict(timer.counts) == {"outer": 1, "inner": 2}
    assert set(timer.summary()) == {"outer", "inner"}
    assert all(v >= 0 for v in timer.totals.values())
    assert list(timer.summary()) == sorted(timer.totals, key=lambda k: -timer.totals[k])
    report = timer.report().splitlines()
    assert len(report) == 2 and any("inner" in line and "x2" in line for line in report)
    timer.reset()
    assert timer.summary() == {} and dict(timer.counts) == {}


def test_stage_records_on_error_and_without_a_profiler():
    timer = StageTimer()
    with pytest.raises(ValueError):
        with timer.stage("failing"):
            raise ValueError("x")
    assert timer.counts["failing"] == 1 and timer.totals["failing"] >= 0


def test_stage_span_from_a_second_thread():
    """With every thread profiled, a stage run in a thread started inside
    the profile appears, on that thread."""
    timer = StageTimer()

    def work():
        with timer.stage("worker"):
            torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU], **profiling._all_threads()) as prof:
        with timer.stage("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    threads = {n: tid for n, _, _, tid in _annotations(prof)}
    assert set(threads) == {"lungmask.main", "lungmask.worker"}
    assert threads["lungmask.main"] != threads["lungmask.worker"]
    assert timer.counts == {"main": 1, "worker": 1}


# -- the inferer's reorientation stages ------------------------------------------


@pytest.mark.parametrize("kind", ["numpy", "image"])
def test_apply_records_reorientation_once_per_call(weights, phantom, kind):
    port = LMInferer(modelpath=weights, **KW)
    inp = phantom if kind == "numpy" else _ras(phantom)
    port.apply(inp)
    assert port.timings.counts["to_lps"] == 1 and port.timings.counts["from_lps"] == 1
    port.apply(inp)
    assert port.timings.counts["to_lps"] == 2 and port.timings.counts["from_lps"] == 2
    assert port.timings.counts["preprocess"] == 2


@pytest.mark.parametrize("path", ["apply", "split"])
def test_fused_pair_records_from_lps_per_model(weights, phantom, path, monkeypatch):
    monkeypatch.setenv("LUNGMASK_TPU_FUSED_THREADS", "1")
    port = LMInferer(modelpath=weights, fillmodel_path=weights, **KW)
    if path == "apply":
        port.apply(_ras(phantom))
    else:
        pre = port.preprocess_image(_ras(phantom))
        port.finish_forward(pre, port.forward_preprocessed(pre))
    counts = port.timings.counts
    assert counts["to_lps"] == 1 and counts["from_lps"] == 2
    assert counts["postprocess"] == 2 and counts["fusion_postprocess"] == 1


# -- the cohort's decode and write ------------------------------------------------


@pytest.mark.parametrize("written", [True, False])
def test_cohort_records_decode_and_write_per_volume(weights, phantom, tmp_path, written):
    port = LMInferer(modelpath=weights, **KW)
    out = str(tmp_path) if written else None
    stats = run_cohort([phantom, _ras(phantom)], port, output_dir=out)
    assert [r.error for r in stats.results] == [None, None]
    counts = port.timings.counts
    assert counts["decode"] == 2 and counts["to_lps"] == 2 and counts["from_lps"] == 2
    if written:
        assert counts["write"] == 2 and len(os.listdir(tmp_path)) == 2
    else:
        assert "write" not in counts
    assert set(stats.stage_seconds) == {"load_busy", "load_wait", "forward_busy", "forward_wait",
                                        "forward_backpressure", "finish_busy", "finish_wait"}


def test_cohort_counts_the_decode_of_a_failed_source(weights, phantom, tmp_path):
    port = LMInferer(modelpath=weights, **KW)
    missing = str(tmp_path / "missing.nii.gz")
    stats = run_cohort([missing, phantom], port, output_dir=str(tmp_path))
    assert stats.results[0].error is not None and stats.results[1].error is None
    counts = port.timings.counts
    assert counts["decode"] == 2 and counts["write"] == 1 and counts["to_lps"] == 1


# -- the benchmark's readers ------------------------------------------------------


READS = {
    "stage_s.reorient": ({"to_lps": 0.3, "from_lps": 0.5}, 0.8),
    "stage_s.decode": ({"decode": 1.2}, 1.2),
    "stage_s.write": ({"write": 2.0}, 2.0),
}


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_gives_seconds_per_volume(metric):
    totals, total = READS[metric]
    read = spec.reader(metric)
    assert read({"volumes": 4, "stage_totals": dict(totals, unet=9.0)}) == pytest.approx(total / 4)
    assert read({"volumes": 0, "stage_totals": totals}) is None
    assert read({"stage_totals": totals}) is None
    for key in totals:  # a program that lacks any of the stages
        assert read({"volumes": 4, "stage_totals": {k: v for k, v in totals.items()
                                                    if k != key}}) is None
    assert read({"volumes": 4}) is None


def test_benchmark_lists_the_readers_where_they_read():
    entries = {m["name"]: m for m in spec.load()["per_layer"]}
    assert entries["stage_s.reorient"]["workloads"] == [
        "r231.apply", "ltrclobes_r231.apply", "r231.cohort"]
    for name in ("stage_s.decode", "stage_s.write"):
        assert entries[name]["workloads"] == ["r231.cohort"]
    for name in READS:
        m = entries[name]
        assert (m["source"], m["moves"], m["unit"]) == ("program_span", "volumes_per_h", "s")


# -- the operator's trace ---------------------------------------------------------


def test_fused_apply_trace_holds_the_finish_threads(weights, phantom, tmp_path, monkeypatch):
    monkeypatch.setenv("LUNGMASK_TPU_FUSED_THREADS", "1")
    monkeypatch.setenv("LUNGMASK_TPU_TRACE_DIR", str(tmp_path))
    LMInferer(modelpath=weights, fillmodel_path=weights, **KW).apply(_ras(phantom))
    spans = _trace_spans(str(tmp_path), "inference")
    assert {"lungmask.to_lps", "lungmask.preprocess", "lungmask.unet", "lungmask.postprocess",
            "lungmask.paste_back", "lungmask.from_lps", "lungmask.fusion_postprocess"} <= set(spans)
    main = spans["lungmask.fusion_postprocess"]
    assert len(main) == 1 and not spans["lungmask.postprocess"] & main
    assert os.listdir(tmp_path) == ["inference"]


def test_cohort_trace_holds_its_threads(weights, phantom, tmp_path, monkeypatch):
    trace_dir, out = tmp_path / "traces", tmp_path / "out"
    out.mkdir()
    monkeypatch.setenv("LUNGMASK_TPU_TRACE_DIR", str(trace_dir))
    port = LMInferer(modelpath=weights, **KW)
    stats = run_cohort([phantom, _ras(phantom)], port, output_dir=str(out))
    assert [r.error for r in stats.results] == [None, None]
    spans = _trace_spans(str(trace_dir), "cohort")
    assert {"lungmask.decode", "lungmask.preprocess", "lungmask.unet", "lungmask.write"} <= set(
        spans)
    loader_t, main_t, finish_t = (spans[f"lungmask.{s}"] for s in ("decode", "unet", "write"))
    assert len(loader_t | main_t | finish_t) == 3
    assert os.listdir(trace_dir) == ["cohort"]


def test_traces_are_cold_when_the_dir_is_unset(weights, phantom, tmp_path, monkeypatch):
    import torch.profiler

    monkeypatch.delenv("LUNGMASK_TPU_TRACE_DIR", raising=False)

    def no_profiler(*a, **k):
        raise AssertionError("a profiler was made with LUNGMASK_TPU_TRACE_DIR unset")

    monkeypatch.setattr(torch.profiler, "profile", no_profiler)
    monkeypatch.chdir(tmp_path)
    LMInferer(modelpath=weights, fillmodel_path=weights, **KW).apply(_ras(phantom))
    stats = run_cohort([phantom], LMInferer(modelpath=weights, **KW))
    assert stats.results[0].error is None
    assert os.listdir(tmp_path) == []


# -- the CLI's cohort summary ------------------------------------------------------


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_cli_cohort_logs_the_stages_and_threads(weights, phantom, tmp_path):
    from lungmask_tpu_torch.io import nifti

    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    for i in range(2):
        nifti.write(MedicalImage(phantom + np.int16(i)), str(src / f"v{i}.nii.gz"))
    records = _Records()
    logger.addHandler(records)
    try:
        cli.main([str(src), str(out), "--cohort", "--modelpath", weights, "--cpu",
                  "--noprogress"])
    finally:
        logger.removeHandler(records)
    (stages,) = [m for m in records.lines if m.startswith("Cohort stages")]
    for name in ("decode", "write", "to_lps", "from_lps", "preprocess", "unet"):
        assert f"  {name} " in stages and "x2" in stages
    (threads,) = [m for m in records.lines if m.startswith("Cohort threads")]
    assert "load_busy" in threads and "finish_wait" in threads
