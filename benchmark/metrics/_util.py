"""Helpers the per-layer readers share (not a metric: the harness reads
only files whose names do not start with ``_``)."""

from __future__ import annotations

from benchmark.roofline import least_time


def per_request_ms(m, layer: str):
    """Device milliseconds of ``layer`` per profiled request, or None
    without a trace of device events."""
    if m.trace is None or not m.profiled or m.trace.busy_s <= 0:
        return None
    total = sum(r.device.get(layer, 0.0) for r in m.profiled)
    return 1e3 * total / len(m.profiled)


def kernel_share(m, kernel: str, work):
    """Percent of the least time of ``kernel``'s work (``work(m, r)`` gives
    ``(flops, bytes)`` of profiled request r) over the device time of the
    port's hand kernels in the profiled requests whose step names
    ``kernel``; None where no such request ran or none took device
    time."""
    if m.trace is None:
        return None
    reqs = [r for r in m.profiled if r.step.get("kernel") == kernel]
    hand = sum(r.device.get("hand", 0.0) for r in reqs)
    if not reqs or hand <= 0:
        return None
    least = sum(least_time(*work(m, r))[0] for r in reqs)
    return 100.0 * least / hand
