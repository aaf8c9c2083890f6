"""The plain reference against the port's plain (CPU) path at a tiny
size, for each of the six entries the cells drive: the same requests, the
same inputs, through ``benchmark.harness`` on both sides."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness

CASES = [("idg.cycle", "image"), ("idg.cycle", "predict"),
         ("idg-aw.cycle", "image"), ("idg-aw.cycle", "predict"),
         ("wproj.dumpcycle", "image"), ("wproj.dumpcycle", "predict")]


def _readings(bench, cell_name, step, device, seed=21):
    cell = harness.Cell(cell_name, seed, device, bench)
    reqs = [r for r in cell.seq if r.step["name"] == step]
    samples = [(r, *cell.call(r)) for r in reqs]
    return harness.compare(samples, cell.cfg, cell.inputs, device)


@pytest.mark.parametrize("cell_name,step", CASES)
def test_reference_matches_the_port_on_the_cpu(tiny_bench, cell_name, step):
    nums = _readings(tiny_bench, cell_name, step, torch.device("cpu"))
    out = "image" if step == "image" else "vis"
    # IDG-AW grids its runs in another order than the reference; the
    # taper division lifts that float32 rounding to ~1e-5 in the image
    assert nums[f"{out}_rel_l2"] < 5e-5
    assert nums[f"{out}_max_err"] < 1e-4
    assert nums["dropped_gap"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name,step", CASES)
def test_reference_matches_the_port_on_the_card(tiny_bench, cuda, cell_name,
                                                step):
    nums = _readings(tiny_bench, cell_name, step, cuda)
    out = "image" if step == "image" else "vis"
    assert nums[f"{out}_rel_l2"] < 1e-4
    assert nums["dropped_gap"] == 0
