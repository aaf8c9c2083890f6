"""Reduction of a ``torch.profiler`` trace to per-request, per-layer device
time (the arithmetic of ``scripts/profile_torch.py``, carried further).

The harness wraps every profiled request in a ``record_function`` range
named ``bench_req#<i>`` and ends it with a synchronise, so every device
event a request caused starts inside its range on the profiler's common
clock.  Device events (kernels, copies, memsets) are summed per request
and per layer of ``layers.json``; the device's busy time is the union of
their intervals.  One stream is assumed, as the program uses.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from pathlib import Path

SPAN = "bench_req#"


def load_layers(bench_dir: Path) -> dict:
    return json.loads((bench_dir / "layers.json").read_text())["layers"]


def classify(name: str, layers: dict) -> str:
    for layer, patterns in layers.items():
        if any(p in name for p in patterns):
            return layer
    return "other"


@dataclass
class Traced:
    """One profiled request: its index into the run's sequence and its
    device seconds by layer."""

    index: int
    device: dict = field(default_factory=dict)


@dataclass
class TraceData:
    requests: list            # [Traced] in order
    busy_s: float             # union of device intervals
    window_s: float           # host clock over the profiled requests
    unattributed_s: float     # device time outside every request's range
    other_names: list         # device event names no layer claimed
    device_ops: list          # [[name, seconds]] most device time first
    idle_gaps: list           # [[host activity, seconds]] longest first


def _union(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, layers: dict, window_s: float, top: int = 10,
           named_gaps: int = 200) -> TraceData:
    """The profiled requests' device time by layer, the busy time, the
    device operations that took most time and the longest idle gaps,
    each of the ``named_gaps`` longest gaps named by the innermost host
    operation running at its middle (or by the request's range where no
    operation ran), the rest summed as "shorter gaps"."""
    from torch.autograd import DeviceType

    spans, cpu, dev = [], [], []
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith(SPAN):
            # the request's range; its device-side copy (a GPU user
            # annotation over the request) is no device work
            if e.device_type != DeviceType.CUDA:
                spans.append((s, t, int(e.name[len(SPAN):])))
        elif e.device_type == DeviceType.CUDA:
            dev.append((s, t, e.name))
        else:
            cpu.append((s, t, e.name))
    spans.sort()
    starts = [s for s, _, _ in spans]
    reqs = {i: Traced(i) for _, _, i in spans}
    other, ops = set(), {}
    unattributed = 0.0
    for s, t, name in dev:
        layer = classify(name, layers)
        if layer == "other":
            other.add(name)
        ops[name] = ops.get(name, 0.0) + (t - s)
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and s <= spans[k][1]:
            d = reqs[spans[k][2]].device
            d[layer] = d.get(layer, 0.0) + (t - s)
        else:
            unattributed += t - s
    gaps = {}
    if spans:
        busy = _merged([(s, t) for s, t, _ in dev])
        edges = [spans[0][0]] + [x for b in busy for x in b] + [spans[-1][1]]
        cuts = sorted(((g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2])
                       if g1 > g0), key=lambda g: g[0] - g[1])
        for g0, g1 in cuts[named_gaps:]:
            gaps["shorter gaps"] = gaps.get("shorter gaps", 0.0) + (g1 - g0)
        for g0, g1 in cuts[:named_gaps]:
            mid = (g0 + g1) / 2
            inner = [c for c in cpu if c[0] <= mid <= c[1]]
            if inner:
                name = max(inner, key=lambda c: c[0])[2]
            else:
                k = bisect.bisect_right(starts, mid) - 1
                name = ("host, in request" if k >= 0 and mid <= spans[k][1]
                        else "host, between requests")
            gaps[name] = gaps.get(name, 0.0) + (g1 - g0)
    by_time = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    return TraceData(
        requests=[reqs[i] for _, _, i in spans],
        busy_s=_union([(s, t) for s, t, _ in dev]),
        window_s=window_s,
        unattributed_s=unattributed,
        other_names=sorted(other),
        device_ops=[[n[:120], v] for n, v in by_time],
        idle_gaps=[[n[:120], v] for n, v in
                   sorted(gaps.items(), key=lambda kv: -kv[1])[:top]])
