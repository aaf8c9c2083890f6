"""Run one cell of ``BENCHMARK.json`` on one NVIDIA GPU and print its
result as one JSON line, the last line of standard output.

    python3 benchmark/run.py --workload idg.cycle --seed 7 --seconds 30 \\
        --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` trace of a few more passes
after the timed window.  Run it from the root of a checkout: it measures
the ``ska_sdp_tpu_torch`` package there, whose CUDA kernels build into
``ska_sdp_tpu_torch/build/`` on the first run.  It exits with a code
other than 0, and prints no result, without a CUDA device, when a
``jax``, ``jaxlib``, ``flax`` or ``ska_sdp_tpu`` module was loaded, and
when the checkout holds no ``ska_sdp_tpu_torch``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    chips = {w["name"]: w["chips"] for w in
             harness.load_spec()["workloads"]}.get(args.workload)
    if chips is None:
        print(f"error: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        import ska_sdp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"error: the program under test is missing: {e}",
              file=sys.stderr)
        return 2
    res = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T0)
    return 0 if res is not None else 3


if __name__ == "__main__":
    sys.exit(main())
