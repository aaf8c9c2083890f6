"""Phase timing, program spans and the process's counters (port of
``ska_sdp_tpu/utils/timing.py``, with the spans and counters the port adds).

Wall-clock phase timers behind one environment surface:
``SKA_SDP_TPU_DUMP_PHASES=1`` prints a line per phase, and
``SKA_SDP_TPU_TRACE_DIR=<dir>`` records a ``torch.profiler`` trace of each
phase into ``<dir>`` (Chrome trace JSON, one file per phase), with the
program's spans of the phase beside it (``<trace>.spans.json``).

:meth:`PhaseTimer.device_stage` runs one pipeline stage as its own
synchronised call and records its time under ``device/<name>``: a warm-up
call, then a timed call, each ended by ``torch.cuda.synchronize()`` on the
CUDA devices its result lives on.  :meth:`PhaseTimer.dispatch_floor`
measures one tiny synchronised operation, the per-stage launch and
synchronisation overhead a reader can subtract.

Spans: :func:`span` marks a block of the program.  While a
``torch.profiler`` session records, each span appends ``(id, parent,
root, name, start_ns, end_ns, counts)`` to a bounded in-memory log
(:func:`spans`, :func:`clear_spans`), stamped by ``time.time_ns()``, the
clock of the profiler's events.  Otherwise a span is a shared no-op
context and records nothing.  A ``host_only`` span also enters a
``record_function`` range of its name, so the profiler's timeline names
host work by it; it must enclose no kernel, copy or memset, because a
range that launches device work gets a device-side copy in the trace.
:func:`add` adds to a count of every open span, so a root sums its
children's counts.  Spans are opened and closed by one thread.

Counters: :data:`COUNTERS` holds the process's counts that outlive a
span (``launches/<kernel>``, ``dropped/<gridder>``, ``split/<kernel>/…``);
:class:`PhaseTimer` keeps its run's counts in a :class:`Counters` of its
own.  A count a kernel makes on the card (:func:`count_on_card`) is copied
to page-locked memory behind the kernel and taken into :data:`COUNTERS`,
and into the open root span, by the next :func:`readback` after the copy
has landed, so that reading it adds no wait of its own.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import re
import time
from typing import Dict, NamedTuple, Optional

import torch

_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_LOG: collections.deque = collections.deque(maxlen=65_536)
_OPEN: list = []                   # the open spans, outermost first
_IDS = itertools.count(1)


class SpanRecord(NamedTuple):
    id: int
    parent: Optional[int]         # None for a root
    root: int
    name: str
    start_ns: int                 # time.time_ns()
    end_ns: int
    counts: dict


class _Span:
    __slots__ = ("name", "counts", "rf", "id", "parent", "root", "t0")

    def __init__(self, name: str, host_only: bool, counts: dict):
        self.name = name
        self.counts = counts
        self.rf = (torch.profiler.record_function(name) if host_only
                   else None)

    def __enter__(self):
        top = _OPEN[-1] if _OPEN else None
        self.id = next(_IDS)
        self.parent = None if top is None else top.id
        self.root = self.id if top is None else top.root
        _OPEN.append(self)
        self.t0 = time.time_ns()
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.time_ns()
        _OPEN.remove(self)
        _LOG.append(SpanRecord(self.id, self.parent, self.root, self.name,
                               self.t0, t1, self.counts))
        return False


def span(name: str, *, host_only: bool = False, **counts):
    """A context that logs the block as span ``name`` with the counts
    ``counts`` (its own, not added to its parents) while a profiler
    records, and does nothing otherwise."""
    if not _enabled():
        return _OFF
    return _Span(name, host_only, counts)


def add(name: str, n=1) -> None:
    """Add ``n`` to count ``name`` of every open span."""
    for s in _OPEN:
        s.counts[name] = s.counts.get(name, 0) + n


def spans() -> list:
    """The logged spans in the order they closed (children before their
    parents), without clearing the log."""
    return list(_LOG)


def clear_spans() -> None:
    _LOG.clear()


def readback(value, convert):
    """``convert(value)``, where ``value`` is a tensor on the entry's
    device that the host reads (``int``, ``float``, ``bool``), logged as
    span ``sdp.readback``; then the card's counts that have landed
    (:func:`settle_counts`).  A value that is no tensor is converted
    without either."""
    if not isinstance(value, torch.Tensor):
        return convert(value)
    with span("sdp.readback"):
        out = convert(value)
    settle_counts()
    return out


class Counters(dict):
    """Named counts."""

    def add(self, key: str, n=1) -> None:
        self[key] = self.get(key, 0) + n

    def group(self, prefix: str) -> dict:
        """The counts under ``prefix``, keyed by the rest of their name."""
        return {k[len(prefix):]: v for k, v in self.items()
                if k.startswith(prefix)}

    def reset(self, prefix: str) -> None:
        for k in [k for k in self if k.startswith(prefix)]:
            del self[k]


COUNTERS = Counters()
_ON_CARD: collections.deque = collections.deque()   # the counts in flight


def count_on_card(counts: torch.Tensor, keys, span_keys) -> None:
    """Count the int tensor ``counts`` ``[k]`` that work on the current
    CUDA stream makes: ``counts[i]`` is added to ``COUNTERS[keys[i]]``,
    and to count ``span_keys[i]`` of the root span open then, by the first
    :func:`settle_counts` after the work is done.  Only the copy to
    page-locked memory is queued here; nothing waits."""
    settle_counts()
    host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
    host.copy_(counts, non_blocking=True)
    landed = torch.cuda.Event()
    landed.record()
    root = _OPEN[0] if _OPEN else None
    _ON_CARD.append((host, landed, keys, span_keys, root))


def settle_counts() -> None:
    """Take the card counts whose copies have landed into
    :data:`COUNTERS` and their root spans, in the order they were queued;
    never waits for the card."""
    while _ON_CARD and _ON_CARD[0][1].query():
        host, _, keys, span_keys, root = _ON_CARD.popleft()
        for key, skey, n in zip(keys, span_keys, host.tolist()):
            COUNTERS.add(key, n)
            if root is not None:
                root.counts[skey] = root.counts.get(skey, 0) + n


def launched(kernel: str) -> None:
    """Count one launch of hand kernel ``kernel`` in :data:`COUNTERS`."""
    COUNTERS.add(f"launches/{kernel}")


def launch_counters(*kernels: str):
    """``(launch_count, reset_launch_count)`` of a kernel module: the
    launches of one of ``kernels`` (the first by default) since the last
    reset, and the reset of all of them."""

    def launch_count(kernel: str = kernels[0]) -> int:
        if kernel not in kernels:
            raise KeyError(kernel)
        return COUNTERS.get(f"launches/{kernel}", 0)

    def reset_launch_count() -> None:
        for k in kernels:
            COUNTERS.pop(f"launches/{k}", None)

    return launch_count, reset_launch_count


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


def block_until_ready(obj):
    """Wait until the devices holding ``obj``'s tensors are done (the
    counterpart of ``jax.block_until_ready``); CPU results are ready."""
    for dev in _cuda_devices(obj, set()):
        torch.cuda.synchronize(dev)
    return obj


@contextlib.contextmanager
def _trace(trace_dir: str, name: str):
    """A ``torch.profiler`` trace of the block, written to ``trace_dir``,
    and the spans the block logged beside it (``.spans.json``: one object
    a span, the fields of :class:`SpanRecord`, in the order they closed)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=acts) as prof:
        yield
    safe = re.sub(r"[^A-Za-z0-9_.+-]", "_", name)
    path = os.path.join(trace_dir, f"{safe}-{os.getpid()}-{time.time_ns()}")
    prof.export_chrome_trace(path + ".json")
    with open(path + ".spans.json", "w") as fh:
        json.dump([s._asdict() for s in _LOG if s.start_ns >= t0], fh)


class PhaseTimer:
    def __init__(self, enabled: bool | None = None,
                 trace_dir: str | None = None, wait: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("SKA_SDP_TPU_DUMP_PHASES", "0") == "1"
        if trace_dir is None:
            trace_dir = os.environ.get("SKA_SDP_TPU_TRACE_DIR") or None
        self.enabled = enabled
        self.trace_dir = trace_dir
        # wait for the card at each phase's end where the times are read:
        # printed, traced, or asked for (``wait=True``); waiting otherwise
        # would stop the host from running ahead of the card (a slab loop)
        self.wait = bool(enabled or trace_dir) if wait is None else wait
        self.times: Dict[str, float] = {}
        # named counts beside the times (e.g. "multichannel/dropped")
        self.counters = Counters()

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the block as phase ``name``, and log it as a span of that
        name; where the times are read (:attr:`wait`) or a profiler
        records, the block's device work is waited for before the clock
        is read."""
        ctx = (_trace(self.trace_dir, name) if self.trace_dir
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx, span(name):
            yield
            if (self.wait or _enabled()) and torch.cuda.is_initialized():
                torch.cuda.synchronize()
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
        out = block_until_ready(fn(*args, **kwargs))
        dt_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kwargs))
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
        block_until_ready(torch.sum(torch.sin(x)))      # warm-up
        t0 = time.perf_counter()
        block_until_ready(torch.sum(torch.sin(x + 1.0)))
        dt = time.perf_counter() - t0
        self.times["device/dispatch-floor"] = dt
        if self.enabled:
            print(f"[device-phase] {'dispatch-floor':<24s} {dt*1e3:10.2f} ms"
                  " (per-stage launch + sync; subtract from each stage)",
                  flush=True)
        return dt
