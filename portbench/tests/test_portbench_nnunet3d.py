"""The nnU-Net 3-D configuration (``families/nnunet3d.py``,
``lanes_extra/apply_kernels.py``, ``reference/nnunet3d.py``) at the
family's CPU size through ``run.main``: the cell prints a ``correct`` line
with every check beside its limit, its traced line holds the new stage's
reader, each planted fault of the port makes it ``correct: false`` through
the check that is meant to catch it, and an unknown family is still named.
"""

import os
import re

import pytest

from portbench import spec
from portbench.tests import tiny

CELL = "nnunet3d_lobes.apply"
CHECKS = {"prep_gap", "logit_gap", "map_mismatch", "finish_mismatch", "patches_miscount"}


def test_cell_prints_a_correct_line():
    line = tiny.run_cell(CELL, seconds=2.0)
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == CHECKS
    assert set(line["metrics"]) == {"volumes_per_h", "volume_p90_s", "setup_s"}
    assert line["checks"]["patches_miscount"]["value"] == 0.0


def test_traced_line_reads_the_export_stage():
    line = tiny.run_cell(CELL, seconds=2.0, trace=1)
    assert line["correct"] is True
    assert {"stage_s.preprocess", "stage_s.unet", "stage_s.export"} <= set(line["metrics"])


@pytest.mark.parametrize("kind,caught_by", [
    ("uniform", "logit_gap"), ("step", "patches_miscount"), ("order1", "prep_gap"),
    ("deepest", "logit_gap")])
def test_each_fault_is_caught(kind, caught_by):
    cell = spec.cell(tiny.bench(), CELL)
    fam = spec.family(cell["config"])
    with fam.fault(cell["config"], kind):
        line = tiny.run_cell(CELL, seconds=1.0)
    assert line["correct"] is False
    c = line["checks"][caught_by]
    assert c["value"] > c["limit"], line["checks"]


def test_unknown_family_is_named():
    def other(cell):
        cell["config"]["family"] = "no_such_3d_family"

    missing = os.path.join("portbench", "families", "no_such_3d_family.py")
    with pytest.raises(FileNotFoundError, match=re.escape(missing)):
        tiny.run_cell(CELL, adjust=other)


def test_readers_on_a_hand_made_trace():
    """The kernels' shares read device time by kernel name inside the
    window; without the lane's bounds (a parent's program) they read
    nothing."""
    trace = {"spans": [("portbench.window", 0, 1000)], "launches": {},
             "device": [("lm_norm3d_stats", 0, 100, 1), ("lm_norm3d_apply", 900, 1200, 2),
                        ("lm_export3d", 10, 60, 3), ("other", 0, 1000, 4)]}
    norm, export, stage = (spec.reader(n) for n in ("norm3d_roofline", "export_roofline",
                                                      "stage_s.export"))
    ctx = {"trace": trace, "volumes": 2, "norm3d_bound_s": 100e-9, "export_bound_s": 25e-9,
           "stage_totals": {"export": 3.0}}
    assert norm(ctx) == 50.0 and export(ctx) == 50.0 and stage(ctx) == 1.5
    bare = {"trace": trace, "volumes": 2, "stage_totals": {}}
    assert norm(bare) is None and export(bare) is None and stage(bare) is None
