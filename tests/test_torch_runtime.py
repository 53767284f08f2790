"""The port's host-heap policy and its ``apply`` trace, against the JAX
package.

* ``tune_host_allocator`` / ``prefault_host_heap``: ``mallopt`` is
  process-wide and cannot be undone, so each package's calls run in a fresh
  interpreter per environment; the sequences of return values must be
  equal. ``LMInferer.__init__`` and ``UNetRunner.__init__`` must call them
  where the JAX package does.
* ``utils.profiling.trace``: with ``LUNGMASK_TPU_TRACE_DIR`` set, a CPU
  ``apply`` leaves a ``torch.profiler`` trace under ``<dir>/inference/``
  that holds the U-Net's convolutions; unset, no profiler is made and
  nothing is written.

Tolerance: none (return values and file contents are compared exactly).
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from lungmask_tpu_torch.models import convert, synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Calls made in one interpreter: repeated calls, a smaller and a larger
# explicit request after the environment's default.
_CALLS = (
    "out = [rt.tune_host_allocator(), rt.prefault_host_heap(), rt.prefault_host_heap(),\n"
    "       rt.tune_host_allocator(), rt.prefault_host_heap(8), rt.prefault_host_heap(24),\n"
    "       rt.prefault_host_heap(), rt.tune_host_allocator()]\n"
    "print(json.dumps(out))\n"
)
ENVS = {
    "default": {},
    "no_malloc_tuning": {"LUNGMASK_TPU_NO_MALLOC_TUNING": "1"},
    "prefault_0": {"LUNGMASK_TPU_PREFAULT_MB": "0"},
    "prefault_16": {"LUNGMASK_TPU_PREFAULT_MB": "16"},
    "no_tuning_prefault_16": {"LUNGMASK_TPU_NO_MALLOC_TUNING": "1",
                              "LUNGMASK_TPU_PREFAULT_MB": "16"},
}


def _heap_calls(package: str, extra_env: dict) -> list:
    env = {k: v for k, v in os.environ.items()
           if k not in ("LUNGMASK_TPU_NO_MALLOC_TUNING", "LUNGMASK_TPU_PREFAULT_MB")}
    env.update(extra_env, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    code = f"import json\nimport {package}.runtime as rt\n" + _CALLS
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(ENVS))
def test_heap_policy_returns_what_jax_returns(case):
    got = _heap_calls("lungmask_tpu_torch", ENVS[case])
    want = _heap_calls("lungmask_tpu", ENVS[case])
    assert got == want
    tuned = case not in ("no_malloc_tuning", "no_tuning_prefault_16")
    assert got[0] is tuned and got[-1] is tuned
    default_mb = int(ENVS[case].get("LUNGMASK_TPU_PREFAULT_MB", 384))
    assert got[1] == got[2] == default_mb
    assert got[5] == max(24, default_mb)


@pytest.fixture()
def weights(tmp_path):
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, synthetic.laterality_params(wf=2))
    return path


def test_inferer_and_runner_apply_the_heap_policy(weights, monkeypatch):
    """``LMInferer.__init__`` tunes the allocator and pre-faults the heap
    (JAX ``inferer.py:120-126``); ``UNetRunner.__init__`` tunes it (JAX
    ``engine.py:255-264``). Recorders stand in: mallopt would stay set in
    this worker."""
    import lungmask_tpu_torch.inferer as inferer
    import lungmask_tpu_torch.runtime as runtime
    from lungmask_tpu_torch.runtime.engine import UNetRunner

    calls = []
    monkeypatch.setattr(inferer, "tune_host_allocator", lambda: calls.append("inferer.tune"))
    monkeypatch.setattr(inferer, "prefault_host_heap", lambda: calls.append("inferer.prefault"))
    monkeypatch.setattr(runtime, "tune_host_allocator", lambda: calls.append("runner.tune"))
    inferer.LMInferer(modelpath=weights, device="cpu", tqdm_disable=True)
    assert calls == ["inferer.tune", "inferer.prefault", "runner.tune"]
    calls.clear()
    UNetRunner(synthetic.laterality_params(wf=2), 3)
    assert calls == ["runner.tune"]


def _apply(weights):
    from lungmask_tpu_torch import LMInferer

    vol = synthetic.lung_phantom(2, size=64)
    return LMInferer(modelpath=weights, device="cpu", tqdm_disable=True).apply(vol)


def test_apply_writes_a_trace_when_the_dir_is_set(weights, tmp_path, monkeypatch):
    trace_dir = tmp_path / "traces"
    monkeypatch.setenv("LUNGMASK_TPU_TRACE_DIR", str(trace_dir))
    mask = _apply(weights)
    files = glob.glob(str(trace_dir / "inference" / "*.pt.trace.json"))
    assert len(files) == 1, os.listdir(trace_dir)
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::conv2d" in names and "aten::convolution" in names
    # The trace reads the env at each call: unset again, nothing more.
    monkeypatch.delenv("LUNGMASK_TPU_TRACE_DIR")
    np.testing.assert_array_equal(_apply(weights), mask)
    assert glob.glob(str(trace_dir / "**" / "*.json"), recursive=True) == files


def test_trace_is_cold_when_the_dir_is_unset(weights, tmp_path, monkeypatch):
    import torch.profiler

    from lungmask_tpu_torch.utils import profiling

    monkeypatch.delenv("LUNGMASK_TPU_TRACE_DIR", raising=False)

    def no_profiler(*a, **k):
        raise AssertionError("a profiler was made with LUNGMASK_TPU_TRACE_DIR unset")

    monkeypatch.setattr(torch.profiler, "profile", no_profiler)
    monkeypatch.chdir(tmp_path)
    with profiling.trace("inference"):
        torch.ones(2).sum()
    _apply(weights)
    assert os.listdir(tmp_path) == ["w.npz"]
