"""The port's measurement tools (``lungmask_tpu_torch/tools/``) on the CPU.

* ``roofline``: its per-op operations and bytes equal the JAX package's
  ``tools/roofline.py`` (jax-free, loaded by path) at chunks 8 and 32, op
  for op (no tolerance: the same integer arithmetic).
* ``layer_bench --cpu``: its op list equals the roofline's at the same tiny
  schedule, and every time is positive (CPU times; the card's come from
  ``chip_smoke.py``).
* ``serve_probe --cpu``: every upload of a tiny phantom answered, each
  stage of the breakdown counted.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
from lungmask_tpu_torch.tools import layer_bench, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_roofline():
    spec = importlib.util.spec_from_file_location(
        "root_roofline", os.path.join(REPO, "tools", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("chunk", [8, 32])
def test_roofline_counts_equal_the_jax_tool(chunk):
    theirs = _root_roofline().build(chunk)
    ours = roofline.build(chunk)
    assert [(flops, nbytes) for _, flops, nbytes in theirs] == [
        (op.flops, op.bytes) for op in ours]
    # the same op at each row (the pool is named for what it is)
    assert [name.replace("maxpool", "avgpool").split()[0] for name, _, _ in theirs] == [
        op.name.split()[0] for op in ours]


def test_roofline_bound_per_chunk(capsys):
    t = roofline.main(["32"])
    out = capsys.readouterr().out
    assert f"{t['bound_ms']:.3f} ms per chunk" in out
    assert max(t["ops_ms"], t["bytes_ms"]) < t["bound_ms"] < t["ops_ms"] + t["bytes_ms"]
    assert t["gflop"] / 32 == pytest.approx(96.2, abs=0.05)


def test_layer_bench_cpu(tmp_path, capsys):
    out = tmp_path / "layers.json"
    result = layer_bench.main(["--cpu", "--json", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    tiny = dict(layer_bench.TINY)
    ops = roofline.build(tiny.pop("chunk"), **tiny)
    assert [r["op"] for r in result["ops"]] == [op.name for op in ops]
    assert result["device"] == "cpu"
    for r in result["ops"]:
        assert r["ms"] > 0 and r["bound_ms"] > 0, r
        if r["kind"] == "conv":  # ms is K4's; the cuDNN conv and its epilogue beside it
            assert r["conv_ms"] > 0 and r["epilogue_ms"] == r["cudnn_ms"] - r["conv_ms"]
            # the route conv_stage.route_of gives: direct below 8 channels (the
            # first conv), tma at multiples of 64, else mma
            op = next(o for o in ops if o.name == r["op"])
            assert r["route"] == ("direct" if op.cin < 8 else "tma" if op.cin % 64 == 0
                                  else "mma"), r
    assert result["forward_ms"] > 0
    assert result["sum_ms"] == pytest.approx(sum(r["ms"] for r in result["ops"]))
    assert result["roofline_ms"] == pytest.approx(roofline.totals(ops)["bound_ms"])
    assert "sum of the ops" in capsys.readouterr().out


def test_serve_probe_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "lungmask_tpu_torch.tools.serve_probe", "3", "2", "--cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    result = json.loads(res.stdout)
    assert result["device"] == "cpu" and result["segmented"] == 3
    assert result["errors"] == 0 and result["transport_errors"] == 0
    stages = result["stages_per_vol"]
    for key in ("spool", "decode", "preprocess", "device", "finish", "encode", "busy"):
        assert stages[f"{key}_seconds"] > 0, key
