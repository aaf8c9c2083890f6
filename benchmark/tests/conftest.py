"""Shared set-up of the benchmark's CPU tests: a copy of the benchmark's
files with the cells shrunk to a size a test can hold (8 stations on a
4 km array, 4 dumps, a 256² grid, a 4-plane qpx=4 bank), run through the port's plain
versions on the CPU.  Tests that need a CUDA device take the ``cuda``
fixture, which skips without one."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "benchmark"


def shrink(bench_dir: Path) -> None:
    """Cut every configuration and mix under ``bench_dir`` to the test
    size, in place."""
    for p in (bench_dir / "configs").glob("*.json"):
        d = json.loads(p.read_text())
        d["telescope"].update(stations=8, core_stations=2, cluster_size=2,
                              core_diameter_m=200.0, cluster_spread_m=20.0,
                              max_baseline_m=4000.0)
        d["observation"].update(dumps=4)
        d["settings"].update(theta=0.05, lam=5120)
        if "nw_planes" in d["settings"]:
            d["settings"].update(nw_planes=4, qpx=4, npix_ff=64)
        p.write_text(json.dumps(d))
    for p in (bench_dir / "mixes").glob("*.json"):
        d = json.loads(p.read_text())
        d["sky"].update(skies=2)
        d["slices"] = min(d.get("slices", 1), 4)
        p.write_text(json.dumps(d))


@pytest.fixture
def tiny_bench(tmp_path) -> Path:
    """A shrunk copy of ``benchmark/`` (and ``BENCHMARK.json`` beside it);
    returns the copy's ``benchmark`` directory."""
    dst = tmp_path / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shrink(dst)
    return dst


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
