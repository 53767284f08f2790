"""The traced run: a ``torch.profiler`` window around the measured loop, the
benchmark's own spans (``record_function("portbench.<stage>")`` around its
calls into each layer), and the reduction of the trace to numbers.

A trace is reduced to three lists (times in ns on the profiler's clock):
``device`` (name, start, end, correlation) for every kernel, copy and set
on the card; ``spans`` (name, start, end) of the benchmark's spans on the
host; ``launches`` {correlation: host start} of the runtime calls that put
work on the card. The functions below take only these, so a hand-made trace
tests them (``portbench/tests``).
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

PREFIX = "portbench."
WINDOW = PREFIX + "window"


def span(name: str):
    """A benchmark span around a call into the program (a no-op cost when
    no profiler runs)."""
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def profiled(enabled: bool) -> Iterator[dict]:
    """Profiles the block when ``enabled``; the yielded dict receives the
    reduced trace (:func:`extract`) when the block ends."""
    out: dict = {}
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    prof.__enter__()
    try:
        with span("window"):
            yield out
            if cuda:
                torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    out.update(extract(prof))


def extract(prof) -> dict:
    device, spans, launches = [], [], {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.is_user_annotation():
            if e.device_type() != cuda and name.startswith(PREFIX):
                spans.append((name, start, end))
        elif e.device_type() == cuda:
            device.append((name, start, end, e.correlation_id()))
        elif name.startswith("cuda") and any(k in name for k in ("Launch", "Memcpy", "Memset")):
            launches[e.correlation_id()] = start
    return {"device": device, "spans": spans, "launches": launches}


def window(trace: dict) -> Tuple[int, int]:
    ws = [(s, e) for n, s, e in trace["spans"] if n == WINDOW]
    return ws[0]


def merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: dict) -> float:
    """Seconds of the window in which anything ran on the card (the union
    of the device intervals, clipped to the window)."""
    w0, w1 = window(trace)
    parts = [(max(s, w0), min(e, w1)) for _, s, e, _ in trace["device"]]
    return sum(e - s for s, e in merged([p for p in parts if p[1] > p[0]])) / 1e9


def window_s(trace: dict) -> float:
    w0, w1 = window(trace)
    return (w1 - w0) / 1e9


def idle_share(trace: dict) -> float:
    """Share of the window in which nothing ran on the card, in %."""
    return 100.0 * (1.0 - busy_s(trace) / window_s(trace))


def top_ops(trace: dict, k: int = 10) -> List[list]:
    """The ``k`` device operations that took most time, by name."""
    by: Dict[str, float] = defaultdict(float)
    for name, s, e, _ in trace["device"]:
        by[name] += (e - s) / 1e9
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def _segments(spans) -> List[Tuple[int, int, str]]:
    """The host's timeline cut at every span boundary, each piece named by
    the innermost benchmark span open over it ("between_spans" where none
    is)."""
    inner = [(s, e, n[len(PREFIX):]) for n, s, e in spans if n != WINDOW]
    cuts = sorted({t for s, e, _ in inner for t in (s, e)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        best = None
        for s, e, n in inner:
            if s <= a and b <= e and (best is None or s >= best[0]):
                best = (s, n)
        out.append((a, b, best[1] if best else "between_spans"))
    return out


def idle_gaps(trace: dict, k: int = 10) -> List[list]:
    """Idle seconds of the card inside the window, summed by what the host
    was doing meanwhile (the innermost benchmark span open over each part of
    each gap); the ``k`` largest."""
    w0, w1 = window(trace)
    busy = merged([(max(s, w0), min(e, w1)) for _, s, e, _ in trace["device"] if e > w0 and s < w1])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    segs = _segments(trace["spans"])
    starts = [a for a, _, _ in segs]
    by: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        covered = 0
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(segs) and segs[i][0] < e:
            a, b, name = segs[i]
            part = min(b, e) - max(a, s)
            if part > 0:
                by[name] += part / 1e9
                covered += part
            i += 1
        if e - s > covered:
            by["between_spans"] += (e - s - covered) / 1e9
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def device_s_in(trace: dict, name: str, kernels_only: bool = True) -> float:
    """Device seconds of the work launched while a span ``name`` was open
    on the host (kernels only by default: no copies or sets)."""
    ranges = [(s, e) for n, s, e in trace["spans"] if n == PREFIX + name]
    total = 0
    for dname, s, e, corr in trace["device"]:
        if kernels_only and (dname.startswith("Memcpy") or dname.startswith("Memset")):
            continue
        t = trace["launches"].get(corr)
        if t is not None and any(a <= t < b for a, b in ranges):
            total += e - s
    return total / 1e9
