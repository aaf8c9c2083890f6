"""One run of one cell: set-up, the timed window, the traced window, the
comparison with the plain reference, and the result line.

Everything a cell is made of sits in files of its own, found by name:

* ``configs/<config>.json``: the deployment (its source, the telescope,
  the observation, the settings the entries and the reference take);
* ``mixes/<traffic>.json``: the skies the requests carry, the request
  sequence (each step names its entry by dotted name, the inputs
  it takes, the output the comparison reads, its reference in
  ``reference/`` and the kernel its roofline reads), how many outputs of
  each step the comparison samples, and how many passes are traced;
* ``limits/<cell>.json``: the limit of each number the comparison prints;
* ``metrics/<metric>.py``: a reader ``read(m)`` of one metric from the
  :class:`Measurement`, returning None where it finds nothing.

So a later cell, mix or metric is new files and new entries of
``BENCHMARK.json``, and no edit here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import observation as obsgen
from . import trace as tracing
from .wbank import w_bank

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ska_sdp_tpu")
VIS_TYPE = "ska_sdp_tpu_torch.models.dataset.VisData"


# --------------------------------------------------------------------------
# finding the parts of a cell by name
# --------------------------------------------------------------------------

def load_spec(bench_dir: Path = BENCH) -> dict:
    return json.loads((bench_dir.parent / "BENCHMARK.json").read_text())


def load_json(bench_dir: Path, kind: str, name: str) -> dict:
    """``<bench_dir>/<kind>/<name>.json`` (``configs``, ``mixes``,
    ``limits``)."""
    return json.loads((bench_dir / kind / f"{name}.json").read_text())


def load_metric(bench_dir: Path, name: str):
    """The reader ``read(m)`` of ``<bench_dir>/metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(dotted: str):
    """The attribute that a dotted name ``package.module.attr`` names."""
    module, attr = dotted.rsplit(".", 1)
    return getattr(importlib.import_module(module), attr)


def load_reference(name: str):
    """The reference function ``<module>.<function>`` of
    ``benchmark/reference/``."""
    return resolve(f"benchmark.reference.{name}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax's, jaxlib's, flax's or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# --------------------------------------------------------------------------
# the cell's inputs
# --------------------------------------------------------------------------

@dataclass
class Request:
    """One position of the request sequence: a step of the mix on sky
    ``sky`` and record slice ``part``."""

    step: dict
    sky: int
    part: int

    @property
    def key(self):
        return (self.step["name"], self.sky, self.part)


class Inputs:
    """The observation, its skies and the resident inputs, made from the
    seed; what a request hands to its entry (``args``) and to the
    reference (``req``).  The visibilities are complex64 and the uvw
    float64 metres, as a measurement set holds them."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        tel, st = cfg["telescope"], cfg["settings"]
        self.ocfg = obsgen.from_config(cfg, mix["sky"]["sources"], seed)
        self.obs = obsgen.simulate_observation(self.ocfg)
        n = self.obs["n"]
        self.skies = [obsgen.sky(self.obs, self.ocfg, k, device)
                      for k in range(mix["sky"]["skies"])]
        parts = mix.get("slices", 1)
        if n % parts:
            raise ValueError(f"{n} records do not split into {parts} slices")
        self.bounds = [(i * n // parts, (i + 1) * n // parts)
                       for i in range(parts)]
        self.uvw = self.obs["uvw"]
        self.a1 = self.obs["antenna1"]
        self.a2 = self.obs["antenna2"]
        self.time = self.obs["time"]
        self.freq = float(self.obs["frequency"][0])
        used = {x for s in mix["steps"] for x in s["inputs"]}
        self.resident = {}
        if "akerns" in used:
            self.resident["akerns"] = obsgen.akern_stamps(
                tel["stations"], self.ocfg.akern_size, seed)[:, 0, 0]
        if "wkerns" in used or "wbins" in used:
            centers = obsgen.w_plane_centers(self.obs, st["nw_planes"])
            self.resident["wbins"] = centers
            self.resident["wkerns"] = w_bank(
                st["theta"], centers, st["qpx"], st["npix_ff"],
                st["support"], device=device)
        self.models = []
        if "model" in used:
            n_grid = int(round(st["theta"] * st["lam"]))
            self.models = [torch.as_tensor(
                obsgen.snapped_model(src, n_grid, st["lam"]), device=device)
                for src, _ in self.skies]
        self.vis_type = resolve(VIS_TYPE)

    def records(self, r: Request) -> int:
        lo, hi = self.bounds[r.part]
        return hi - lo

    def req(self, r: Request) -> dict:
        """The request's inputs as plain arrays, for the reference."""
        lo, hi = self.bounds[r.part]
        out = {"uvw": self.uvw[lo:hi], "vis": self.skies[r.sky][1][lo:hi],
               "a1": self.a1[lo:hi], "a2": self.a2[lo:hi],
               "time": self.time[lo:hi], "freq": self.freq}
        out.update(self.resident)
        if self.models:
            out["model"] = self.models[r.sky]
        return out

    def args(self, r: Request) -> list:
        """The entry's positional inputs, in the step's order."""
        q = self.req(r)
        out = []
        for name in r.step["inputs"]:
            if name == "vis":
                out.append(self.vis_type(q["vis"], q["uvw"], q["a1"],
                                         q["a2"], q["time"], q["freq"]))
            else:
                out.append(q[name])
        return out


def sequence(mix: dict) -> list:
    """One pass of the mix: every step, on every record slice of every
    sky."""
    return [Request(step, k, p)
            for k in range(mix["sky"]["skies"])
            for p in range(mix.get("slices", 1))
            for step in mix["steps"]]


# --------------------------------------------------------------------------
# what the metric readers see
# --------------------------------------------------------------------------

@dataclass
class Profiled:
    step: dict
    req: dict
    key: tuple
    device: dict


@dataclass
class Measurement:
    setup_s: float
    window_s: float
    latencies_s: list
    vis_done: int
    cfg: dict
    device: object
    grid_n: int
    trace: object = None
    profiled: list = field(default_factory=list)
    _cache: dict = field(default_factory=dict)

    def cached(self, r: Profiled, name: str, fn):
        """``fn(r.req)``, computed once per request inputs and name."""
        k = (r.key, name)
        if k not in self._cache:
            self._cache[k] = fn(r.req)
        return self._cache[k]


# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------

def _gaps(out, ref):
    """``(relative L2, max |Δ| / max |ref|)`` in float64."""
    a = out.detach().to(torch.complex128 if out.is_complex()
                        else torch.float64)
    b = ref.detach().to(a.dtype).to(a.device)
    d = a - b
    return (float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(b)),
            float(d.abs().max() / b.abs().max()))


def compare(samples, cfg: dict, inputs: Inputs, device, rnd=None,
            ref_cache=None) -> dict:
    """Numbers of the sampled requests against the reference:
    ``<output>_rel_l2`` and ``<output>_max_err`` (the largest over the
    samples, over the reference's ``region`` of an image) and
    ``dropped_gap``.  ``rnd`` replaces the reference's
    rounding on the program's side (the control)."""
    from .reference.common import exact
    nums = {}
    cache = {} if ref_cache is None else ref_cache
    for r, out, dropped in samples:
        if r.key not in cache:
            cache[r.key] = load_reference(r.step["reference"])(
                inputs.req(r), cfg["settings"], device, exact)
        ref = cache[r.key]
        if rnd is not None:
            alt = load_reference(r.step["reference"])(
                inputs.req(r), cfg["settings"], device, rnd)
            out, dropped = alt[r.step["output"]], alt["dropped"]
        o = r.step["output"]
        want = ref[o]
        if "region" in ref:
            lo, hi = ref["region"]
            out, want = out[lo:hi, lo:hi], want[lo:hi, lo:hi]
        rel, mx = _gaps(out, want)
        nums[f"{o}_rel_l2"] = max(nums.get(f"{o}_rel_l2", 0.0), rel)
        nums[f"{o}_max_err"] = max(nums.get(f"{o}_max_err", 0.0), mx)
        nums["dropped_gap"] = max(nums.get("dropped_gap", 0),
                                  abs(int(dropped) - int(ref["dropped"])))
    return nums


def judge(nums: dict, limits: dict):
    """``(correct, {name: {"value", "limit"}})``: every number at or under
    its limit; a number without a limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in
              sorted(nums.items())}
    ok = bool(checks) and all(
        c["limit"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, mix, limits and
    inputs made from ``seed`` on ``device``."""

    def __init__(self, name: str, seed: int, device,
                 bench_dir: Path = BENCH):
        spec = load_spec(bench_dir)
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec, self.device = spec, device
        self.cell = cells[name]
        self.cfg = load_json(bench_dir, "configs", self.cell["config"])
        self.mix = load_json(bench_dir, "mixes", self.cell["traffic"])
        self.limits = load_json(bench_dir, "limits", name)
        self.inputs = Inputs(self.cfg, self.mix, seed, device)
        self.seq = sequence(self.mix)
        kw = {k: self.cfg["settings"][k] for k in self.cfg["entry_kwargs"]}
        self.kwargs = dict(kw, device=device)
        self.entries = {s["name"]: resolve(s["entry"])
                        for s in self.mix["steps"]}

    def call(self, r: Request, wrap=None):
        """Run request ``r`` and wait for its result on the card; returns
        ``(output tensor, records dropped)``.  ``wrap(fn, r)`` may stand
        between the harness and the entry (the fault tests)."""
        fn = self.entries[r.step["name"]]
        if wrap is not None:
            fn = wrap(fn, r)
        res = fn(*self.inputs.args(r), **self.kwargs)
        out = getattr(res, r.step["output"])
        dropped = getattr(res, r.step["dropped"]) if "dropped" in r.step \
            else 0
        _sync(self.device)
        return out, int(dropped)

    def metric_names(self, group: str) -> list:
        return [m["name"] for m in self.spec[group]
                if "workloads" not in m
                or self.cell["name"] in m["workloads"]]


def run(name: str, seed: int, seconds: float, trace: bool, device,
        t0: float, bench_dir: Path = BENCH, out=None, err=None, wrap=None):
    """One run of cell ``name``; prints the result line on ``out`` and the
    compared numbers last on ``err``.  Returns the result dict, or None
    where a forbidden module was loaded (then nothing is printed)."""
    out = out or sys.stdout
    err = err or sys.stderr
    cell = Cell(name, seed, device, bench_dir)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for r in cell.seq:                         # warm-up: one whole pass
        cell.call(r, wrap)
    _sync(device)

    rng = random.Random(seed)
    k_per_step = cell.mix.get("sample_per_step", 2)
    seen, samples = {}, {}
    latencies, vis_done, failed, i = [], 0, 0, 0
    t_start = time.perf_counter()
    setup_s = t_start - t0
    t_end = t_start
    while i < len(cell.seq) or t_end - t_start < seconds:
        r = cell.seq[i % len(cell.seq)]
        t1 = time.perf_counter()
        try:
            o, dropped = cell.call(r, wrap)
        except Exception as e:  # a request that raises is a failed one
            print(f"request {i} ({r.key}) raised {type(e).__name__}: {e}",
                  file=err)
            _sync(device)
            o, dropped = None, -1
        t_end = time.perf_counter()
        latencies.append(t_end - t1)
        if o is None or dropped != 0:
            failed += 1
        else:
            vis_done += cell.inputs.records(r)
        name_s = r.step["name"]
        seen[name_s] = seen.get(name_s, 0) + 1
        bucket = samples.setdefault(name_s, [])
        if o is not None:                      # reservoir sampling
            if len(bucket) < k_per_step:
                bucket.append((r, o.detach().clone(), dropped))
            else:
                slot = rng.randrange(seen[name_s])
                if slot < k_per_step:
                    bucket[slot] = (r, o.detach().clone(), dropped)
        i += 1
    window_s = t_end - t_start
    m = Measurement(setup_s, window_s, latencies, vis_done,
                    cell.cfg["settings"], device,
                    int(round(cell.cfg["settings"]["theta"]
                              * cell.cfg["settings"]["lam"])))

    if trace:
        layers = tracing.load_layers(bench_dir)
        todo = cell.seq * cell.mix.get("trace_passes", 1)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            tp = time.perf_counter()
            for j, r in enumerate(todo):
                with torch.profiler.record_function(f"{tracing.SPAN}{j}"):
                    cell.call(r, wrap)
            tp = time.perf_counter() - tp
        m.trace = tracing.reduce(prof, layers, tp)
        m.profiled = [Profiled(todo[t.index].step, cell.inputs.req(
            todo[t.index]), todo[t.index].key, t.device)
            for t in m.trace.requests]
        if m.trace.other_names:
            print("unclassified device events: "
                  + "; ".join(n[:100] for n in m.trace.other_names), file=err)
        print(f"traced {len(todo)} requests in {tp:.3f} s; device busy "
              f"{m.trace.busy_s:.6f} s, outside every request "
              f"{m.trace.unattributed_s:.6f} s", file=err)

    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": peak}
    print(f"card: {_card() if device.type == 'cuda' else 'cpu'}; "
          f"torch {torch.__version__}; peak device memory {peak} bytes "
          f"(torch.cuda.max_memory_allocated); {i} requests in "
          f"{window_s:.3f} s", file=err)

    # the comparison, once the window has closed and the memory is read
    del cell.entries
    if device.type == "cuda":
        torch.cuda.empty_cache()
    flat = [s for b in samples.values() for s in b]
    tc = time.perf_counter()
    nums = compare(flat, cell.cfg, cell.inputs, device)
    print(f"compared {len(flat)} outputs with the reference in "
          f"{time.perf_counter() - tc:.3f} s", file=err)
    nums["failed"] = failed
    missing = [s["name"] for s in cell.mix["steps"] if not samples.get(
        s["name"])]
    ok, checks = judge(nums, cell.limits)
    if missing:
        ok = False
        print(f"no output of {missing} to compare", file=err)

    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    units = {x["name"]: x["unit"] for x in cell.spec[group]}
    for mname in cell.metric_names(group):
        v = load_metric(bench_dir, mname)(m)
        if v is not None:
            metrics[mname] = {"value": float(v), "unit": units[mname]}
    result = {"correct": ok, "attempted": i, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = m.trace.busy_s
        dev_info["window_s"] = m.trace.window_s
        result["breakdown"] = {"device_ops": m.trace.device_ops,
                               "idle_gaps": m.trace.idle_gaps}
    result["checks"] = checks

    bad = forbidden_modules()
    if bad:
        print(f"refused: loaded {bad}", file=err)
        return None
    print(json.dumps(result), file=out, flush=True)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    return result
