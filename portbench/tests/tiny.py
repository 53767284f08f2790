"""A cell run on the CPU at a size a test can hold, as the configuration's
family shrinks it (the 2-D U-Net: wf 3, 8 slices of 128²; fine-tuning: 2
volumes of 16), the chip check skipped.

The cells that ``PERF.md`` leaves out of ``BENCHMARK.json`` for now keep
their entries in ``left_out_cells.json`` (as a benchmark PR would add them
back), and :func:`bench` holds them, so their lanes stay tested.
"""

from __future__ import annotations

import contextlib
import io
import json
import os

from portbench import run, spec

LEFT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "left_out_cells.json")


WF = spec.family({}).TINY_WF  # the 2-D U-Net's width here


def shrink(cell: dict) -> None:
    spec.family(cell["config"]).shrink(cell)


def _with_left_out(b: dict) -> dict:
    with open(LEFT_OUT) as f:
        extra = json.load(f)
    for key, entries in extra.items():
        b[key] = b[key] + entries
    return b


def bench() -> dict:
    """``BENCHMARK.json`` and the left-out cells' entries."""
    return _with_left_out(spec.load())


@contextlib.contextmanager
def left_out_cells():
    """``spec.load`` returns :func:`bench`'s content inside the block."""
    real = spec.load
    spec.load = lambda root=spec.ROOT: _with_left_out(real(root))
    try:
        yield
    finally:
        spec.load = real


def run_cell(name: str, *, seed: int = 4294967311, seconds: float = 1.5, trace: int = 0,
             adjust=None) -> dict:
    """The cell's result line, parsed."""
    def both(cell):
        shrink(cell)
        if adjust is not None:
            adjust(cell)

    out = io.StringIO()
    with contextlib.redirect_stdout(out), left_out_cells():
        rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], require_chip=False, adjust=both)
    assert rc == 0, rc
    return json.loads(out.getvalue().strip().splitlines()[-1])
