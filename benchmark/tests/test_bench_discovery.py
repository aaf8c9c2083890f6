"""A configuration, a traffic mix, a metric and a cell added as new files
(and new entries of ``BENCHMARK.json``) are found by name, and no file
the benchmark already has is edited."""

from __future__ import annotations

import hashlib
import io
import json
import time

import torch

from benchmark import harness


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_config_mix_metric_and_cell_are_found(tiny_bench):
    before = _digests(tiny_bench)
    cfg = json.loads((tiny_bench / "configs" / "ska1low-idg.json")
                     .read_text())
    cfg.update(name="tiny-idg-b10")
    cfg["settings"]["taper_beta"] = 10.0
    (tiny_bench / "configs" / "tiny-idg-b10.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny_bench / "mixes" / "idg.cycle.json").read_text())
    mix["steps"] = mix["steps"][:1]
    mix["sky"]["skies"] = 1
    (tiny_bench / "mixes" / "image.only.json").write_text(json.dumps(mix))
    (tiny_bench / "limits" / "tiny.new.json").write_text(json.dumps(
        {"image_rel_l2": 1e-5, "image_max_err": 1e-4, "dropped_gap": 0,
         "failed": 0}))
    (tiny_bench / "metrics" / "requests_done.py").write_text(
        "def read(m):\n    return len(m.latencies_s)\n")
    spec_path = tiny_bench.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["configs"].append({"name": "tiny-idg-b10", "source": "test",
                            "file": "benchmark/configs/tiny-idg-b10.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.new", "config": "tiny-idg-b10",
                              "traffic": "image.only", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["tiny.new"]})
    spec_path.write_text(json.dumps(spec))

    out = io.StringIO()
    res = harness.run("tiny.new", 3, 0.2, False, torch.device("cpu"),
                      time.perf_counter(), bench_dir=tiny_bench, out=out,
                      err=io.StringIO())
    assert res["correct"], res["checks"]
    assert res["metrics"]["requests_done"]["value"] == res["attempted"]
    # request_ms_p95 lists its cells; the new cell is not among them
    assert set(res["metrics"]) == {"vis_per_s", "setup_s", "requests_done"}
    assert json.loads(out.getvalue().splitlines()[-1]) == res
    after = _digests(tiny_bench)
    assert {p: d for p, d in after.items() if p in before} == before


def test_result_line_keys_and_checks_last(tiny_bench):
    out, err = io.StringIO(), io.StringIO()
    res = harness.run("wproj.fast", 5, 0.2, True, torch.device("cpu"),
                      time.perf_counter(), bench_dir=tiny_bench, out=out,
                      err=err)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert res["correct"] and res["failed"] == 0
    tail = err.getvalue().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)
