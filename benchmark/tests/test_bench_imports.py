"""What the benchmark loads: a fresh process that imports
``benchmark/run.py``, the harness, the metrics and the reference and runs
a tiny cell holds no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``ska_sdp_tpu``; the reference alone holds none of
``ska_sdp_tpu_torch`` either.  Names are compared whole: the port's name
begins with the JAX package's."""

from __future__ import annotations

import json
import subprocess
import sys

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = r"""
import io, json, sys, time
from pathlib import Path
sys.path.insert(0, {root!r})
import torch
import benchmark.run
from benchmark import harness
harness.run("idg.cycle", 4, 0.1, True, torch.device("cpu"),
            time.perf_counter(), bench_dir=Path({bench!r}),
            out=io.StringIO(), err=io.StringIO())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = r"""
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from benchmark.reference import common, idg, wproj
req = {{"uvw": np.zeros((2, 3)), "vis": np.ones(2), "freq": 299792458.0}}
common.weighted_mirrored(req, {{"theta": 0.05, "lam": 5120}},
                         torch.device("cpu"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_run_loads_no_jax_nor_the_jax_package(tiny_bench):
    mods = _top_level(RUN.format(root=str(ROOT), bench=str(tiny_bench)))
    assert "ska_sdp_tpu_torch" in mods and "benchmark" in mods
    assert not mods & {"jax", "jaxlib", "flax", "ska_sdp_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level(REF.format(root=str(ROOT)))
    assert not mods & {"jax", "jaxlib", "flax", "ska_sdp_tpu",
                       "ska_sdp_tpu_torch"}
