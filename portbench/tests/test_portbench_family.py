"""A configuration's model family and a traffic file's lane are resolved from
files of their own (``families/<family>.py``, ``lanes_extra/<lane>.py``):
a configuration of a new family, with its cells under the harness's lanes
or a lane of its own, comes in as new files and new ``BENCHMARK.json``
entries alone; a name with no file stops the run, naming the file; and the
lungmask 2-D U-Net, the family of every configuration that names none,
reads what it read before it moved behind the resolver.

``GOLDEN`` was recorded on the parent commit of that move (the harness with
the 2-D code in ``lanes.py``, ``calibrate.py`` and ``tests/tiny.py``), on
the CPU with torch on one thread (the order of a float reduction follows
the thread count), three times with equal results: the
weights as ``Run.model_trees()`` made them at ``tiny``'s size, the cost as
``Run.forward_cost(192)`` gave it at full width, and each check's value of a
``tiny.run_cell`` run of each cell with the traffic's pool cut to one
volume (so that the window's length does not decide which volumes are
checked).
"""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import lanes, spec
from portbench.tests import tiny

SEED = 4294967311
CPU = torch.device("cpu")
TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy")

GOLDEN = {
    "weights": {
        "r231": "53ff5b037b407f19ae30b3c753eae3bdb1a70ed648657d99ac23383baf93e828",
        "ltrclobes_r231": "d69582c3f5d0e5187a0d13a2369c8e11b1f1e89f4b71d5f3a081bb11afefc30d",
    },
    "forward_cost": {
        "r231": {"flops": 18470506856448.0, "bound_s": 0.028611071074640147},
        "ltrclobes_r231": {"flops": 36945845551104.0, "bound_s": 0.057267215954653436},
    },
    "checks": {
        "r231.apply": {"map_mismatch": 8.7738037109375e-05, "finish_mismatch": 0.0,
                       "logit_gap": 0.004602399654686451},
        "ltrclobes_r231.apply": {"map_mismatch": 0.000164031982421875, "finish_mismatch": 0.0,
                                 "logit_gap": 0.0043807923793792725},
        "r231.cohort": {"map_mismatch": 8.7738037109375e-05, "finish_mismatch": 0.0,
                        "logit_gap": 0.004602399654686451},
        "r231.finetune": {"loss_gap": 0.0012483581194526689, "grad_gap": 0.02575281296071101,
                          "change_gap": 0.02247951558988581},
    },
}


def _digest(trees) -> str:
    h = hashlib.sha256()
    for t in trees:
        for k, v in t.items():
            a = np.ascontiguousarray(np.asarray(v, np.float32))
            h.update(k.encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", ["r231.apply", "ltrclobes_r231.apply"])
def test_default_family_weights_and_cost_unchanged(name):
    cell = spec.cell(tiny.bench(), name)
    config = cell["workload"]["config"]
    fam = spec.family(cell["config"])
    assert os.path.basename(fam.__file__) == "unet2d.py" and "family" not in cell["config"]
    tr = cell["traffic"]
    cost = fam.forward_cost(cell["config"], (192, tr["size"], tr["size"]), tuple(tr["spacing"]))
    assert tr["slices"] == 192 and cost == GOLDEN["forward_cost"][config]
    tiny.shrink(cell)
    r = lanes.Run(SimpleNamespace(seed=SEED, seconds=1, trace=0), cell, CPU, 0.0)
    try:
        assert _digest(r.family.weights(r)) == GOLDEN["weights"][config]
    finally:
        r.cleanup()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _one_volume(cell):
    if cell["traffic"]["lane"] != "finetune":
        cell["traffic"]["pool"] = 1


@pytest.mark.parametrize("name", ["r231.apply", "ltrclobes_r231.apply", "r231.cohort",
                                  "r231.finetune"])
def test_default_family_checks_unchanged(name, one_thread):
    line = tiny.run_cell(name, seed=SEED, seconds=1.5, adjust=_one_volume)
    assert line["correct"] is True
    assert {k: v["value"] for k, v in line["checks"].items()} == GOLDEN["checks"][name]


@pytest.mark.parametrize("key,value,missing", [
    ("config", "no_such_family", os.path.join("portbench", "families", "no_such_family.py")),
    ("traffic", "no_such_lane", os.path.join("portbench", "lanes_extra", "no_such_lane.py")),
])
def test_unknown_family_or_lane_names_its_file(key, value, missing):
    def name_it(cell):
        cell[key]["family" if key == "config" else "lane"] = value

    with pytest.raises(FileNotFoundError, match=re.escape(missing)):
        tiny.run_cell("r231.apply", adjust=name_it)


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".pyc"):
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


TOY_RUN = """
import json
from portbench.tests.tiny import run_cell
for name in ("toy_band.apply", "toy_band.fixed"):
    print("LINE " + json.dumps(run_cell(name, seconds=1.0)))
try:
    run_cell("toy_band.finetune")
except RuntimeError as e:
    print("REFUSED " + str(e))
"""


def test_new_family_and_lane_come_as_files(tmp_path):
    """The toy family (``tests/toy/families/toy_band.py``: a seeded HU
    threshold with a NumPy reference) under the harness's ``apply`` lane and
    under a lane of its own (``tests/toy/lanes_extra/toy_fixed.py``),
    added to a copy of the benchmark as new files and new entries, run
    through ``run.main`` on the CPU; the finetune lane refuses it, naming
    what it lacks."""
    root = str(tmp_path)
    pb = os.path.join(root, "portbench")
    shutil.copytree(os.path.join(spec.ROOT, "portbench"), pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    before = _digests(pb)
    for kind in ("families", "lanes_extra", "configs", "traffic", "limits"):
        os.makedirs(os.path.join(pb, kind), exist_ok=True)
        for f in os.listdir(os.path.join(TOY, kind)):
            if not os.path.isfile(os.path.join(TOY, kind, f)):
                continue  # a __pycache__ left by an import
            assert not os.path.exists(os.path.join(pb, kind, f))
            shutil.copy(os.path.join(TOY, kind, f), os.path.join(pb, kind, f))
    with open(os.path.join(TOY, "benchmark_entries.json")) as f:
        entries = json.load(f)
    bench = spec.load(root)
    bench["configs"] += entries["configs"]
    bench["workloads"] += entries["workloads"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.get("workloads", []).extend(entries["metric_workloads"].get(m["name"], []))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    assert {k: v for k, v in _digests(pb).items() if k in before} == before

    out = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=root, capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([root, spec.ROOT])))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x[5:]) for x in out.stdout.splitlines() if x.startswith("LINE ")]
    assert len(lines) == 2
    for line, e2e in zip(lines, [{"volumes_per_h", "volume_p90_s", "setup_s"},
                                 {"volumes_per_h", "setup_s"}]):
        assert line["correct"] is True and line["attempted"] > 0, line
        assert set(line["metrics"]) == e2e
        assert set(line["checks"]) == {"mask_mismatch"}
    refused = [x for x in out.stdout.splitlines() if x.startswith("REFUSED ")]
    assert refused and "toy_band.py gives no training step" in refused[0], out.stdout[-2000:]
