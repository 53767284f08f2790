"""Finds everything of a cell by the names in ``BENCHMARK.json``: its
configuration file, its traffic file (``traffic/<name>.json``), its limits
(``limits/<cell>.json``), its metrics, and each per-layer metric's reader
(``layer_metrics/<metric>.py``, a function ``read(ctx)`` that returns a
number, or None where it finds nothing to read)."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """The cell ``name`` with its parts resolved: ``workload``, ``config``
    (the configuration file's content), ``traffic``, ``limits``,
    ``end_to_end`` and ``per_layer`` (the metric entries it reports)."""
    w = _by_name(bench["workloads"], name, "workload")
    c = _by_name(bench["configs"], w["config"], "configuration")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return {
        "workload": w,
        "config": _json(root, c["file"]),
        "traffic": _json(root, "portbench", "traffic", w["traffic"] + ".json"),
        "limits": _json(root, "portbench", "limits", name + ".json"),
        "end_to_end": e2e,
        "per_layer": layer,
    }


def reader(metric: str, root: str = ROOT) -> Callable[[dict], Optional[float]]:
    path = os.path.join(root, "portbench", "layer_metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("portbench.layer_metrics." + metric, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_layer_metrics(entries: List[dict], ctx: dict, root: str = ROOT) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
