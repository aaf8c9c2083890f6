"""The readings the comparison's limits are set from, for one cell, on many
seeds in one process (the benchmark's own runs do not run this):

* the program: every request of the first ``--skies`` skies of one pass
  of the mix, through the timed path, against the plain reference;
* the control: the reference itself in the program's place, its products
  on TF32 operands (``reference.common.tf32``), against the reference.

    python3 benchmark/calibrate.py --workload idg.cycle \\
        --seeds 11 12 13 ... [--skies 2]

One JSON line a seed (``program`` and ``control`` numbers), then one
line with the largest program reading and the smallest control reading
of each number.  It needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--skies", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness
    from benchmark.reference.common import tf32

    if not torch.cuda.is_available():
        print("error: no CUDA device visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    lower, upper = {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = harness.Cell(args.workload, seed, dev)
        reqs = [r for r in cell.seq if r.sky < args.skies]
        samples = [(r, *cell.call(r)) for r in reqs]
        cache = {}
        prog = harness.compare(samples, cell.cfg, cell.inputs, dev,
                               ref_cache=cache)
        ctrl = harness.compare(samples, cell.cfg, cell.inputs, dev, rnd=tf32,
                               ref_cache=cache)
        for k, v in prog.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in ctrl.items():
            upper[k] = min(upper.get(k, v), v)
        print(json.dumps({"seed": seed, "requests": len(samples),
                          "program": prog, "control": ctrl,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del cell, samples, cache
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "lower": lower, "upper": upper,
                      "card": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
