"""Phase timing (port of ``ska_sdp_tpu/utils/timing.py``).

Wall-clock phase timers behind one environment surface:
``SKA_SDP_TPU_DUMP_PHASES=1`` prints a line per phase, and
``SKA_SDP_TPU_TRACE_DIR=<dir>`` records a ``torch.profiler`` trace of each
phase into ``<dir>`` (Chrome trace JSON, one file per phase).

:meth:`PhaseTimer.device_stage` runs one pipeline stage as its own
synchronised call and records its time under ``device/<name>``: a warm-up
call, then a timed call, each ended by ``torch.cuda.synchronize()`` on the
CUDA devices its result lives on.  :meth:`PhaseTimer.dispatch_floor`
measures one tiny synchronised operation, the per-stage launch and
synchronisation overhead a reader can subtract.
"""

from __future__ import annotations

import contextlib
import os
import re
import time
from typing import Dict

import torch


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of the tensors in ``obj`` (nested tuples, lists,
    dicts and named tuples)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, found)
    return found


def _block(obj):
    """Wait until the devices holding ``obj``'s tensors are done (the
    counterpart of ``jax.block_until_ready``); CPU results are ready."""
    for dev in _cuda_devices(obj, set()):
        torch.cuda.synchronize(dev)
    return obj


@contextlib.contextmanager
def _trace(trace_dir: str, name: str):
    """A ``torch.profiler`` trace of the block, written to ``trace_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    safe = re.sub(r"[^A-Za-z0-9_.+-]", "_", name)
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{safe}-{os.getpid()}-{time.time_ns()}.json"))


class PhaseTimer:
    def __init__(self, enabled: bool | None = None,
                 trace_dir: str | None = None):
        if enabled is None:
            enabled = os.environ.get("SKA_SDP_TPU_DUMP_PHASES", "0") == "1"
        if trace_dir is None:
            trace_dir = os.environ.get("SKA_SDP_TPU_TRACE_DIR") or None
        self.enabled = enabled
        self.trace_dir = trace_dir
        self.times: Dict[str, float] = {}
        # named counts beside the times (e.g. "multichannel/dropped")
        self.counters: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        ctx = (_trace(self.trace_dir, name) if self.trace_dir
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        if self.enabled:
            print(f"[phase] {name:<28s} {dt*1e3:10.2f} ms", flush=True)

    def report(self) -> str:
        return "\n".join(
            f"{k:<28s} {v*1e3:10.2f} ms" for k, v in self.times.items())

    def device_stage(self, name: str, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` twice, a warm-up (the first call
        builds the CUDA kernels it launches) and a timed re-run on the same
        inputs, each waited for on the device; record the re-run's wall
        time as ``device/<name>`` and the first call's as
        ``device/<name>+compile``, and return the result."""
        t0 = time.perf_counter()
        out = _block(fn(*args, **kwargs))
        dt_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = _block(fn(*args, **kwargs))
        dt = time.perf_counter() - t0
        key = f"device/{name}"
        self.times[f"{key}+compile"] = (
            self.times.get(f"{key}+compile", 0.0) + dt_first)
        self.times[key] = self.times.get(key, 0.0) + dt
        if self.enabled:
            print(f"[device-phase] {name:<24s} {dt*1e3:10.2f} ms "
                  f"(first call incl. compile: {dt_first*1e3:.2f} ms)",
                  flush=True)
        return out

    def dispatch_floor(self, device="cpu") -> float:
        """One-time measurement of the per-stage launch and synchronisation
        overhead: a tiny operation on ``device``, waited for."""
        x = torch.arange(8.0, device=device)
        _block(torch.sum(torch.sin(x)))                 # warm-up
        t0 = time.perf_counter()
        _block(torch.sum(torch.sin(x + 1.0)))
        dt = time.perf_counter() - t0
        self.times["device/dispatch-floor"] = dt
        if self.enabled:
            print(f"[device-phase] {'dispatch-floor':<24s} {dt*1e3:10.2f} ms"
                  " (per-stage launch + sync; subtract from each stage)",
                  flush=True)
        return dt
