"""Command-line interface of the port (the ``--mode idg`` and
``--make-data`` surfaces of ``ska_sdp_tpu/cli.py``, same flag names).

Examples:
    python -m ska_sdp_tpu_torch.cli --make-data data/ --nant 16 --ntime 24
    python -m ska_sdp_tpu_torch.cli --mode idg -i data/ --all -o img.h5
    python -m ska_sdp_tpu_torch.cli --mode idg -i data/ --all --device cpu

Modes and flags of the reference that are not ported yet are accepted by
the parser and exit with status 2 and a "not yet ported" message.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_MODES = ["aw", "w", "idg", "wcache", "conv", "simple", "predict"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ska_sdp_tpu_torch",
        description="SKA-SDP gridding/imaging on PyTorch + CUDA")
    p.add_argument("-n", type=int, default=None, help="visibility count cap")
    p.add_argument("--all", action="store_true", help="use every visibility")
    p.add_argument("-i", "--input-dir", default="data",
                   help="input directory (reads vis.h5)")
    p.add_argument("-o", "--output", default=None, help="output .h5 (/img)")
    p.add_argument("--mode", choices=_MODES, default="idg",
                   help="pipeline; only idg (image-domain gridding) is "
                        "ported")
    p.add_argument("--subgrid", type=int, default=64,
                   help="IDG subgrid size (32, 64 or 128)")
    p.add_argument("--fov-pad", type=float, default=None,
                   help="IDG full-FOV guarantee: grid FOV/f and crop")
    p.add_argument("--precision", choices=["single", "double"],
                   default="single",
                   help="input precision; the gridder runs in float32")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the CUDA kernels) or cpu "
                        "(their plain versions)")
    p.add_argument("-dphases", "--dump-phases", action="store_true",
                   help="print per-phase wall-clock timings")
    p.add_argument("--theta", type=float, default=0.008)
    p.add_argument("--lam", type=int, default=300000)
    # reference flags of surfaces not ported yet
    p.add_argument("--channels", type=int, default=None,
                   help="spectral cubes (not yet ported)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-device imaging (not yet ported)")
    p.add_argument("--device-phases", action="store_true",
                   help="staged device timings (not yet ported)")
    p.add_argument("--idg", action="store_true",
                   help="IDG realisation of aw/predict (not yet ported)")
    # synthetic-data generation
    p.add_argument("--make-data", metavar="DIR", default=None,
                   help="write a synthetic DIR/vis.h5 and exit")
    p.add_argument("--nant", type=int, default=16)
    p.add_argument("--ntime", type=int, default=24)
    p.add_argument("--nchan", type=int, default=1,
                   help="--make-data: spectral channels to simulate")
    p.add_argument("--chan-bw", type=float, default=1.0e5,
                   help="--make-data: channel spacing in Hz")
    return p


def _not_ported(what: str) -> int:
    print(f"error: {what} is not yet ported to ska_sdp_tpu_torch "
          "(use ska_sdp_tpu)", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.make_data:
        from .io.synthetic import (SyntheticConfig, simulate_observation,
                                   write_vis_file)

        cfg = SyntheticConfig(theta=args.theta, lam=args.lam,
                              nant=args.nant, ntime=args.ntime,
                              nchan=args.nchan, chan_bw=args.chan_bw)
        os.makedirs(args.make_data, exist_ok=True)
        obs = simulate_observation(cfg)
        path = os.path.join(args.make_data, "vis.h5")
        write_vis_file(path, obs)
        print(f"wrote {{'vis': {path!r}}} ({obs['n']} visibilities)")
        return 0

    if args.mode != "idg":
        return _not_ported(f"--mode {args.mode}")
    for flag, on in (("--channels", args.channels not in (None, 1)),
                     ("--distributed", args.distributed),
                     ("--device-phases", args.device_phases),
                     ("--idg", args.idg)):
        if on:
            return _not_ported(flag)

    import torch

    from .config import GridParams, ImagingConfig
    from .models import dataset as ds

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to run the plain "
              "versions", file=sys.stderr)
        return 1
    vis_path = os.path.join(args.input_dir, "vis.h5")
    if not os.path.exists(vis_path):
        print(f"error: input file not found: {vis_path}", file=sys.stderr)
        return 1
    cfg = ImagingConfig(grid=GridParams(theta=args.theta, lam=args.lam),
                        precision_name=args.precision,
                        n_vis=None if args.all else args.n)
    print(time.strftime("%Y-%m-%d %H:%M:%S"), "start imaging", flush=True)
    t0 = time.perf_counter()
    try:
        mx, _ = ds.idg_gridding(vis_path, n=cfg.n_vis, outfile=args.output,
                                config=cfg, subgrid=args.subgrid,
                                fov_pad=args.fov_pad, device=device)
    except (FileNotFoundError, ValueError, KeyError,
            NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.dump_phases:
        print(f"phase idg_gridding (read + image + write): "
              f"{time.perf_counter() - t0:.3f} s on {device}")
    print(f"image max: {mx}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
