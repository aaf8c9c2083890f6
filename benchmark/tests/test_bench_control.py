"""The comparison's limits separate: at a test size on the CPU, the
control (the reference with its products on TF32 operands, in the
program's place) fails every cell's committed limits, and so does a run
whose timed path is broken underneath (half of the records left out, the
rest scaled up as a mean over them; one answer altered where it is
produced), while the sound run passes."""

from __future__ import annotations

import io
import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.reference.common import tf32

CELLS = ["idg.cycle", "wproj.dumpcycle", "idg-aw.cycle", "wproj.fast"]
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(tiny_bench, name):
    cell = harness.Cell(name, 8, CPU, tiny_bench)
    samples = [(r, *cell.call(r)) for r in cell.seq]
    cache = {}
    sound = harness.compare(samples, cell.cfg, cell.inputs, CPU,
                            ref_cache=cache)
    ctrl = harness.compare(samples, cell.cfg, cell.inputs, CPU, rnd=tf32,
                           ref_cache=cache)
    assert harness.judge(dict(sound, failed=0), cell.limits)[0]
    assert not harness.judge(dict(ctrl, failed=0), cell.limits)[0]


def _half(fn, r):
    """The entry on the first half of the records only: an image made from
    them and doubled (a mean over the rest), a prediction of the rest
    left at zero."""
    def call(vd, *args, **kw):
        m = vd.vis.shape[0] // 2
        res = fn(vd._replace(vis=vd.vis[:m], uvw=vd.uvw[:m],
                             antenna1=vd.antenna1[:m],
                             antenna2=vd.antenna2[:m], time=vd.time[:m]),
                 *args, **kw)
        if hasattr(res, "image"):
            return res._replace(image=res.image * 2)
        vis = torch.zeros(vd.vis.shape[0], dtype=res.vis.dtype)
        vis[:m] = res.vis
        return res._replace(vis=vis)
    return call


def _altered(fn, r):
    """The entry with one answer altered where it is produced: the
    brightest pixel of an image, or the largest visibility, off by 1%."""
    def call(*args, **kw):
        res = fn(*args, **kw)
        field = "image" if hasattr(res, "image") else "vis"
        x = getattr(res, field).clone()
        flat = x.reshape(-1)
        i = int(torch.argmax(flat.abs()))
        flat[i] = flat[i] * 1.01
        return res._replace(**{field: x})
    return call


@pytest.mark.parametrize("fault", [None, _half, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_bench, name, fault):
    out = io.StringIO()
    res = harness.run(name, 9, 0.1, False, CPU, time.perf_counter(),
                      bench_dir=tiny_bench, out=out, err=io.StringIO(),
                      wrap=fault)
    assert json.loads(out.getvalue().splitlines()[-1])["correct"] is \
        res["correct"]
    assert res["correct"] is (fault is None), res["checks"]
