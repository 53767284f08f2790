"""A whole run on the CPU at a small size: the last line's keys, the
checks beside their limits on standard error, no JAX and no JAX package in
the process, and a run with the timed path broken comes out not correct
(half of each batch left out, an answer altered where it is produced, the
U-Net's deepest level zeroed beyond its carried channels, a train step that
leaves its state unchanged)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import spec
from portbench.tests.tiny import WF, bench, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", ["r231.apply", "ltrclobes_r231.apply", "r231.finetune",
                                  "r231.cohort"])
def test_last_line_keys(name):
    line = run_cell(name)
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    cell = spec.cell(bench(), name)
    assert set(line["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("name", ["r231.apply", "r231.finetune"])
def test_traced_line(name):
    line = run_cell(name, trace=1)
    assert list(line) == KEYS[:4] + ["breakdown", "device", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    cell = spec.cell(bench(), name)
    assert set(line["metrics"]) <= {m["name"] for m in cell["per_layer"]}


def test_fresh_process_loads_no_jax():
    code = (
        "import sys; sys.argv=['x']\n"
        "from portbench.tests.tiny import run_cell\n"
        "from portbench.run import forbidden_modules\n"
        "run_cell('r231.apply'); run_cell('r231.finetune')\n"
        "print('FORBIDDEN', forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "r231.apply",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def _half_slices(monkeypatch):
    """Half of each volume's slices left out of the U-Net's class maps (one
    model's and the fused pair's)."""
    from lungmask_tpu_torch import inferer
    from lungmask_tpu_torch.runtime import engine

    real, real_pair = engine.UNetRunner.run_numpy, inferer.run_pair_numpy

    def run_numpy(self, slices):
        out = real(self, slices)
        out[out.shape[0] // 2:] = 0
        return out

    def run_pair_numpy(a, b, slices):
        maps = real_pair(a, b, slices)
        for m in maps:
            m[m.shape[0] // 2:] = 0
        return maps

    monkeypatch.setattr(engine.UNetRunner, "run_numpy", run_numpy)
    monkeypatch.setattr(inferer, "run_pair_numpy", run_pair_numpy)


def _altered_answer(monkeypatch):
    """The finished mask's lung labels swapped where it is produced."""
    from lungmask_tpu_torch import inferer

    real = inferer.LMInferer._from_lps

    def from_lps(self, outmask, *a):
        out = real(self, outmask, *a)
        return np.where(out == 1, 2, np.where(out == 2, 1, out)).astype(out.dtype)

    monkeypatch.setattr(inferer.LMInferer, "_from_lps", from_lps)


def _deep_level_zeroed(monkeypatch):
    """Channels 3 and up of K4's stages at the U-Net's deepest level left
    zero: the lung bands intact, the deep levels' data gone."""
    from lungmask_tpu_torch.ops.kernels import conv_stage as k4

    from portbench import calibrate

    monkeypatch.setattr(k4, "conv_stage",
                        calibrate.zero_deepest(k4.conv_stage, {"wf": WF, "depth": 5}))


@pytest.mark.parametrize("name", ["r231.apply", "ltrclobes_r231.apply", "r231.cohort"])
@pytest.mark.parametrize("fault", [_half_slices, _altered_answer, _deep_level_zeroed])
def test_broken_inference_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line = run_cell(name)
    assert line["correct"] is False, line["checks"]


def _state_unchanged(monkeypatch):
    from lungmask_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "apply_updates", lambda params, updates: None)


def _half_batch(monkeypatch):
    from lungmask_tpu_torch.train import loop

    real = loop.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)
        return lambda state, images, labels: step(state, images[: len(images) // 2],
                                                  labels[: len(labels) // 2])

    monkeypatch.setattr(loop, "make_train_step", make)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_broken_train_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line = run_cell("r231.finetune")
    assert line["correct"] is False, line["checks"]
