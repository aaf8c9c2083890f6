"""The cell ``wcache.psf`` (PSF-normalised w-cache imaging, ``psf_image``)
at a test size on the CPU, its w range narrowed to ±120 wavelengths (3
planes of the default kernel shape) to fit the test size's snapshot: the
sound run reads ``correct``; the control (the reference with its products
on TF32 operands) fails every committed limit of the image and of the PSF;
three broken timed paths fail them too: the image halved; the CLI's
default bin width of 2,000 wavelengths, one plane at w = 0, in place of
the configuration's 120; and the PSF alone gridded through unconjugated
kernels, which leaves the image and the PSF's peak as they were.  A traced run carries
the span and counter readers' numbers, a bank for the image and another
for the PSF.  The roofline's count of the least work, at the reference's
in-bounds patch cells, against a hand count; the readers giving None
without the program's spans; and the reference loading nothing of the
program in a fresh interpreter."""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.metrics import issue_synth_ms, synth_planes
from benchmark.metrics import wcache_grid_roofline as roof
from benchmark.reference import psf
from benchmark.reference.common import tf32
from ska_sdp_tpu_torch.models import imaging
from ska_sdp_tpu_torch.utils import timing

CELL = "wcache.psf"
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def bench(tiny_bench):
    p = tiny_bench / "configs" / "ska1low-wcache.json"
    cfg = json.loads(p.read_text())
    cfg["settings"]["w_range"] = [-120, 120]
    p.write_text(json.dumps(cfg))
    return tiny_bench


def test_the_control_fails_the_limits(bench):
    cell = harness.Cell(CELL, 8, CPU, bench)
    samples = [(r, *cell.call(r)) for r in cell.seq]
    cache = {}
    sound = harness.compare(samples, cell.cfg, cell.inputs, CPU,
                            ref_cache=cache)
    ctrl = harness.compare(samples, cell.cfg, cell.inputs, CPU, rnd=tf32,
                           ref_cache=cache)
    assert harness.judge(dict(sound, failed=0), cell.limits)[0]
    assert not harness.judge(dict(ctrl, failed=0), cell.limits)[0]
    for k in ("image_rel_l2", "image_max_err", "psf_rel_l2", "psf_max_err"):
        assert ctrl[k] > cell.limits[k], k


def _halved(fn, r):
    """The entry's image halved where it is produced."""
    def call(*args, **kw):
        res = fn(*args, **kw)
        return res._replace(image=res.image * 0.5)
    return call


def _default_wstep(fn, r):
    """The CLI's default bin width in place of the configuration's."""
    def call(*args, **kw):
        return fn(*args, **dict(kw, wstep=2000.0))
    return call


def _psf_unconjugated(fn, r):
    """The PSF's bank, the second a call builds, left unconjugated: the
    image and the PSF's peak stay as they were."""
    def call(*args, **kw):
        built = []
        real = imaging.w_kernel_bank

        def bank(*a, **k):
            b = real(*a, **k)
            built.append(b)
            return torch.conj(b).resolve_conj() if len(built) == 2 else b
        imaging.w_kernel_bank = bank
        try:
            return fn(*args, **kw)
        finally:
            imaging.w_kernel_bank = real
    return call


@pytest.mark.parametrize("fault", [None, _halved, _default_wstep,
                                   _psf_unconjugated])
def test_a_broken_timed_path_is_not_correct(bench, fault):
    out = io.StringIO()
    res = harness.run(CELL, 2**31 + 9, 0.1, False, CPU, time.perf_counter(),
                      bench_dir=bench, out=out, err=io.StringIO(),
                      wrap=fault)
    assert json.loads(out.getvalue().splitlines()[-1])["correct"] is \
        res["correct"]
    assert res["correct"] is (fault is None), res["checks"]
    if fault is _psf_unconjugated:        # only the PSF's numbers see it
        c = res["checks"]
        assert c["image_rel_l2"]["value"] <= c["image_rel_l2"]["limit"]
        assert c["image_max_err"]["value"] <= c["image_max_err"]["limit"]
        assert c["psf_rel_l2"]["value"] > c["psf_rel_l2"]["limit"]
    assert set(res["metrics"]) == {"vis_per_s", "setup_s"}


def test_a_traced_run_carries_the_synthesis_readers(bench):
    timing.clear_spans()        # the harness reads one run's log a process
    res = harness.run(CELL, 5, 0.1, True, CPU, time.perf_counter(),
                      bench_dir=bench, out=io.StringIO(), err=io.StringIO())
    assert res["correct"]
    # no device trace on the CPU: the device readers find nothing
    assert "wcache_grid_roofline" not in res["metrics"]
    assert res["metrics"]["synth_planes"]["value"] == 2 * 3
    assert res["metrics"]["issue_synth_ms"]["value"] > 0


def test_the_span_readers_give_none_without_the_log():
    m = harness.Measurement(0.0, 1.0, [0.1], 10, {}, CPU, 256)
    assert synth_planes.read(m) is None
    assert issue_synth_ms.read(m) is None


def _req(uvw):
    n = len(uvw)
    return {"uvw": np.asarray(uvw, np.float64), "vis": np.ones(n),
            "a1": np.zeros(n), "a2": np.ones(n), "time": np.zeros(n),
            "freq": 299792458.0}


def test_taps_and_the_roofline_work_by_hand():
    cfg = {"theta": 0.05, "lam": 5120, "qpx": 8, "support": 15,
           "wstep": 120, "w_range": [-1920, 1920]}
    N = 256
    # at f = c the uvw are wavelengths; x = 128 + u/20, the patch from
    # cell ⌊x + 1/16⌋ − 7: record 0 whole (225 cells), record 1 (v < 0,
    # mirrored) cut to 12 columns at the right edge (180), record 2 wholly
    # right of the grid (0)
    uvw = [[200.0, 200.0, 0.0], [-(N / 2 - 5) * 20.0, -0.0001, 5.0],
           [(N / 2 + 15) * 20.0, 0.0, 0.0]]
    req = _req(uvw)
    assert psf.taps(req, cfg, CPU) == 225 + 180
    assert psf.planes(cfg) == 33
    m = harness.Measurement(0.0, 1.0, [], 0, cfg, CPU, N)
    r = harness.Profiled({"kernel": "wproj_grid"}, req, ("image", 0, 0), {})
    bank = 33 * 64 * 225 * 8
    # two scatters a request: the image's and the PSF's
    assert roof._work(m, r) == (2 * 8 * 405,
                                2 * (24 * 3 + bank + 8 * N * N))


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import json, sys\nsys.path.insert(0, {str(ROOT)!r})\n"
            "import torch\n"
            "from benchmark.reference import psf\n"
            "cfg = {'theta': 0.05, 'npix_ff': 16, 'qpx': 2, 'support': 3}\n"
            "psf.w_planes(torch.tensor([0.0, 10.0]), cfg, 'cpu')\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    mods = set(json.loads(out.stdout.splitlines()[-1]))
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "ska_sdp_tpu",
                       "ska_sdp_tpu_torch"}
