"""Every cell resolves its parts by name, and adding a configuration, a
traffic mix, a limit file and a per-layer metric takes only new files."""

import hashlib
import json
import os
import shutil

import pytest

from portbench import spec
from portbench.tests.tiny import bench

CONTRACT_E2E_KEYS = {"name", "unit", "better", "bound", "source"}
CONTRACT_LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_resolves():
    """Every cell of BENCHMARK.json and every left-out cell's entry."""
    full = bench()
    assert "r231.finetune" in {w["name"] for w in full["workloads"]}
    for w in full["workloads"]:
        cell = spec.cell(full, w["name"])
        assert cell["traffic"]["lane"] in ("apply", "finetune", "cohort")
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert callable(spec.reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell["end_to_end"]}
        for name in cell["limits"]:
            assert isinstance(cell["limits"][name], float)
        cfg = cell["config"]
        assert cfg["reduced"] == [] and cfg["wf"] == 6 and cfg["depth"] == 5


def test_benchmark_file_keys():
    """BENCHMARK.json, and the left-out cells' entries that would join it,
    have the contract's keys."""
    full = bench()
    assert set(spec.load()) == {"command", "paths", "run_seconds", "configs", "workloads",
                                "end_to_end", "per_layer"}
    assert "r231.finetune" not in {w["name"] for w in spec.load()["workloads"]}
    for c in full["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in full["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in full["end_to_end"]:
        assert set(m) - {"workloads"} == CONTRACT_E2E_KEYS
    for m in full["per_layer"]:
        assert set(m) - {"workloads"} == CONTRACT_LAYER_KEYS


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_cell_needs_only_new_files(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    before = _digests(os.path.join(root, "portbench"))
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "r231_wide.json"), "w") as f:
        json.dump(dict(json.load(open(os.path.join(pb, "configs", "r231.json"))), chunk=64), f)
    with open(os.path.join(pb, "traffic", "apply_devpost.json"), "w") as f:
        json.dump(dict(json.load(open(os.path.join(pb, "traffic", "apply.json"))),
                       inferer={"postprocessing_mode": "device"}), f)
    with open(os.path.join(pb, "limits", "r231_wide.apply_devpost.json"), "w") as f:
        json.dump({"map_mismatch": 0.5}, f)
    with open(os.path.join(pb, "layer_metrics", "throwaway.share.py"), "w") as f:
        f.write("def read(ctx):\n    return 42.0 if ctx.get('volumes') else None\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "r231_wide", "source": "https://example.org",
                             "file": "portbench/configs/r231_wide.json", "reduced": [],
                             "why": "throwaway"})
    bench["workloads"].append({"name": "r231_wide.apply_devpost", "config": "r231_wide",
                               "traffic": "apply_devpost", "chips": 1, "why": "throwaway"})
    bench["per_layer"].append({"name": "throwaway.share", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "model",
                               "moves": "volumes_per_h", "workloads": ["r231_wide.apply_devpost"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("volumes_per_h", "volume_p90_s"):
            m["workloads"].append("r231_wide.apply_devpost")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.cell(spec.load(root), "r231_wide.apply_devpost", root)
    assert cell["config"]["chunk"] == 64
    assert cell["traffic"]["inferer"] == {"postprocessing_mode": "device"}
    assert [m["name"] for m in cell["per_layer"]][-1] == "throwaway.share"
    values = spec.read_layer_metrics(cell["per_layer"], {"volumes": 1}, root)
    assert values["throwaway.share"]["value"] == 42.0
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("name", ["r231.apply", "r231.finetune"])
def test_a_cell_runs_the_new_traffic_data(name, monkeypatch):
    """A traffic file's parameters reach the lane (here the pool size)."""
    from portbench.tests.tiny import run_cell

    def more(cell):
        key = "volumes" if cell["traffic"]["lane"] == "finetune" else "pool"
        cell["traffic"][key] = 3

    line = run_cell(name, adjust=more)
    assert line["attempted"] > 0


def test_pool_is_drawn_from_the_seed():
    """The same seed gives the same volumes, another seed others, and the
    shape and type never move."""
    import numpy as np
    import torch

    from portbench import phantom

    cpu = torch.device("cpu")
    a, b = (phantom.pool(2**40 + 1, 2, 4, 64, cpu) for _ in range(2))
    c = phantom.pool(3, 2, 4, 64, cpu)
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    assert not np.array_equal(a[0][0], c[0][0])
    assert all(v.dtype.name == "int16" and v.shape == (4, 64, 64) for v, _ in a + c)
