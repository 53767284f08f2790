"""Finds everything of a cell by the names in ``BENCHMARK.json``: its
configuration file, its traffic file (``traffic/<name>.json``), its limits
(``limits/<cell>.json``), its metrics, each per-layer metric's reader
(``layer_metrics/<metric>.py``, a function ``read(ctx)`` that returns a
number, or None where it finds nothing to read), and the configuration's
model family (``families/<family>.py``, :func:`family`). A lane that the
harness does not have is found the same way (``lanes.resolve``)."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
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


def module(kind: str, name: str, root: str = ROOT) -> ModuleType:
    """``portbench/<kind>/<name>.py`` loaded by path; where there is no such
    file, the error names the one it looked for."""
    path = os.path.join(root, "portbench", kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"portbench: {name!r} names no file of {kind}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DEFAULT_FAMILY = "unet2d"  # the lungmask 2-D U-Net, of every configuration that names none


def family(config: dict, root: str = ROOT) -> ModuleType:
    """The model family of a configuration: ``families/<config["family"]>.py``."""
    return module("families", config.get("family", DEFAULT_FAMILY), root)


def reader(metric: str, root: str = ROOT) -> Callable[[dict], Optional[float]]:
    return module("layer_metrics", metric, root).read


def read_layer_metrics(entries: List[dict], ctx: dict, root: str = ROOT) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
