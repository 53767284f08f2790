"""The yardstick's arithmetic: the frozen roofline count, the trace's idle
union, the kernels inside a span, and the mfu readers, on hand-made
numbers."""

import pytest

from portbench import roofline, spec, tracing


def test_frozen_roofline_count():
    t = roofline.totals(roofline.build(32))
    assert round(t["gflop"], 1) == 3078.4
    assert round(t["mb"], 1) == 9973.2
    assert round(t["bound_ms"], 3) == 4.769
    assert round(t["gflop"] / 32, 1) == 96.2
    whole = roofline.forward_cost(192, 32)
    assert whole["flops"] == pytest.approx(6 * t["gflop"] * 1e9)
    assert whole["bound_s"] == pytest.approx(6 * t["bound_ms"] / 1e3)


def _trace():
    ms = 1_000_000
    return {
        "spans": [("portbench.window", 0, 100 * ms), ("portbench.preprocess", 0, 30 * ms),
                  ("portbench.forward", 30 * ms, 60 * ms), ("portbench.finish", 60 * ms, 100 * ms)],
        # kernels launched at 5 ms (preprocess) and 31/32 ms (forward), a copy at 59 ms
        "launches": {1: 5 * ms, 2: 31 * ms, 3: 32 * ms, 4: 59 * ms},
        "device": [("k1", 10 * ms, 20 * ms, 1), ("conv", 35 * ms, 50 * ms, 2),
                   ("pool", 45 * ms, 55 * ms, 3), ("Memcpy DtoH", 58 * ms, 60 * ms, 4)],
    }


def test_idle_union():
    t = _trace()
    # busy: [10,20] + [35,55] (overlap merged) + [58,60] = 10 + 20 + 2 = 32 ms
    assert tracing.busy_s(t) == pytest.approx(0.032)
    assert tracing.window_s(t) == pytest.approx(0.1)
    gaps = dict(tracing.idle_gaps(t))
    # gaps [0,10] and [20,30] in preprocess, [30,35] and [55,58] in forward,
    # [60,100] in finish
    assert gaps == pytest.approx({"preprocess": 0.020, "forward": 0.008, "finish": 0.040})
    assert tracing.top_ops(t)[0] == ["conv", pytest.approx(0.015)]


def test_kernels_inside_span_and_readers():
    t = _trace()
    assert tracing.device_s_in(t, "forward") == pytest.approx(0.025)  # conv + pool
    assert tracing.device_s_in(t, "forward", kernels_only=False) == pytest.approx(0.027)
    assert tracing.device_s_in(t, "preprocess") == pytest.approx(0.010)
    ctx = {"trace": t, "volumes": 2, "window_s": 0.1, "forward_bound_s": 0.010,
           "forward_flops": 0.5 * 989e12 * 0.1}
    assert spec.reader("unet_roofline")(ctx) == pytest.approx(40.0)
    assert spec.reader("idle_share.volume")(ctx) == pytest.approx(68.0)
    assert spec.reader("idle_share.train")(ctx) is None  # no steps: not a training window
    assert spec.reader("idle_share.train")({"trace": t, "steps": 5}) == pytest.approx(68.0)
    assert spec.reader("idle_share.volume")({"trace": t, "steps": 5}) is None
    assert spec.reader("mfu.volume")(ctx) == pytest.approx(50.0)
    assert spec.reader("mfu.train")({"slices": 8, "window_s": 2.0,
                                     "train_flops": 989e12}) == pytest.approx(50.0)
    assert spec.reader("unet_roofline")({"volumes": 2}) is None
    assert spec.reader("stage_s.fusion")({"volumes": 2, "stage_totals": {}}) is None
    assert spec.reader("stage_s.unet")({"volumes": 4, "stage_totals": {"unet": 2.0}}) == 0.5
    assert spec.reader("cohort_busy.finish")(
        {"cohort_stage_seconds": {"finish_busy": 3.0}, "cohort_wall_s": 4.0}) == 75.0


def test_idle_gaps_take_the_innermost_span():
    """The train lane's spans nest (``augment`` inside ``step``): a gap is
    split by the innermost span open over each part of it."""
    ms = 1_000_000
    t = {"spans": [("portbench.window", 0, 40 * ms), ("portbench.step", 0, 20 * ms),
                   ("portbench.augment", 2 * ms, 8 * ms), ("portbench.step", 20 * ms, 40 * ms)],
         "launches": {}, "device": [("k", 10 * ms, 30 * ms, 1)]}
    assert dict(tracing.idle_gaps(t)) == pytest.approx(
        {"augment": 0.006, "step": 0.014})
