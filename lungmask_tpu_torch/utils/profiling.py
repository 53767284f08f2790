"""Per-stage wall-clock timing and optional profiler traces (counterpart of
``lungmask_tpu.utils.profiling``).

* :class:`StageTimer` accumulates seconds per pipeline stage across volumes
  and is exposed as ``LMInferer.timings``. A stage that launches device work
  must end in a synchronisation for its time to mean anything; the
  inferer's stages all end in a host copy, which synchronises, or (the
  U-Net stage of device postprocessing, whose class map stays on the
  device) in an explicit ``torch.cuda.synchronize``.
* :func:`trace` writes a ``torch.profiler`` trace (TensorBoard's
  ``*.pt.trace.json``, also readable in Perfetto) when
  ``LUNGMASK_TPU_TRACE_DIR`` is set, and is a no-op otherwise, so it can
  stay in the hot path.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        # '+=' on the defaultdicts is not atomic; serialize the update.
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [
            f"  {name:<20s} {secs:8.3f}s ({100 * secs / total:5.1f}%)  x{self.counts[name]}"
            for name, secs in self.summary().items()
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(name: str = "lungmask_tpu_torch") -> Iterator[None]:
    """``torch.profiler`` trace into ``$LUNGMASK_TPU_TRACE_DIR/<name>/``
    (no-op when unset; the variable is read at each call). Records the CPU,
    and the GPU's kernels once this process has initialised CUDA."""
    trace_dir = os.environ.get("LUNGMASK_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    handler = tensorboard_trace_handler(os.path.join(trace_dir, name))
    with profile(activities=activities, on_trace_ready=handler):
        yield
