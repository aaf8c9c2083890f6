"""Command-line interface of the port (the ``--mode idg``, ``--mode aw
--idg``, ``--mode predict --idg [--aterms]`` and ``--make-data`` surfaces
of ``ska_sdp_tpu/cli.py``, same flag names and messages).

Examples:
    python -m ska_sdp_tpu_torch.cli --make-data data/ --nant 16 --ntime 24
    python -m ska_sdp_tpu_torch.cli --mode idg -i data/ --all -o img.h5
    python -m ska_sdp_tpu_torch.cli --mode idg -i data/ --all --device cpu
    python -m ska_sdp_tpu_torch.cli --mode aw --idg -i data/ --all -o aw.h5
    python -m ska_sdp_tpu_torch.cli --mode predict --idg --aterms -i data/ \
        --all --model aw.h5 -o pred.h5

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
                   help="input directory (reads vis.h5, and akern.h5 for "
                        "--mode aw and --aterms)")
    p.add_argument("-o", "--output", default=None,
                   help="output .h5 (/img, or /vis/model for predict)")
    p.add_argument("--mode", choices=_MODES, default="idg",
                   help="pipeline; ported: idg (image-domain gridding), aw "
                        "with --idg (IDG-AW imaging) and predict with --idg "
                        "(model image -> vis, IDG or IDG-AW degridding)")
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
                   help="use the IDG realization for --mode predict "
                        "(continuous-w degridding) or --mode aw (IDG-AW: "
                        "image-domain A-screens on pair-chunked subgrids); "
                        "no wkern file needed either way (the only "
                        "realization of aw and predict ported)")
    p.add_argument("--aterms", action="store_true",
                   help="--mode predict --idg: apply direction-dependent "
                        "antenna terms from akern.h5 (IDG-AW degridding)")
    p.add_argument("--model", default=None,
                   help="model image .h5 (/img) for --mode predict")
    # synthetic-data generation
    p.add_argument("--make-data", metavar="DIR", default=None,
                   help="write a synthetic DIR/vis.h5 and DIR/akern.h5 and "
                        "exit (no wkern.h5: nothing in the port reads a "
                        "w-kernel bank yet)")
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
        from .io.synthetic import SyntheticConfig, generate_dataset

        cfg = SyntheticConfig(theta=args.theta, lam=args.lam,
                              nant=args.nant, ntime=args.ntime,
                              nchan=args.nchan, chan_bw=args.chan_bw)
        paths, obs = generate_dataset(args.make_data, cfg)
        print(f"wrote {paths} ({obs['n']} visibilities)")
        return 0

    if args.mode in ("aw", "predict") and not args.idg:
        return _not_ported(f"--mode {args.mode} without --idg")
    if args.mode not in ("idg", "aw", "predict"):
        return _not_ported(f"--mode {args.mode}")
    for flag, on in (("--channels", args.channels not in (None, 1)),
                     ("--distributed", args.distributed),
                     ("--device-phases", args.device_phases)):
        if on:
            return _not_ported(flag)
    if args.aterms and not (args.mode == "predict" and args.idg):
        print("error: --aterms requires --mode predict --idg",
              file=sys.stderr)
        return 1
    if args.mode == "predict" and not args.model:
        print("error: --mode predict requires --model", file=sys.stderr)
        return 1

    import torch

    from .config import GridParams, ImagingConfig
    from .models import dataset as ds

    vis_path = os.path.join(args.input_dir, "vis.h5")
    akern_path = os.path.join(args.input_dir, "akern.h5")
    required = [vis_path]
    if args.mode == "aw" or args.aterms:
        required.append(akern_path)
    for path in required:
        if not os.path.exists(path):
            print(f"error: input file not found: {path}", file=sys.stderr)
            return 1
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to run the plain "
              "versions", file=sys.stderr)
        return 1
    cfg = ImagingConfig(grid=GridParams(theta=args.theta, lam=args.lam),
                        precision_name=args.precision,
                        n_vis=None if args.all else args.n)
    print(time.strftime("%Y-%m-%d %H:%M:%S"), "start imaging", flush=True)
    t0 = time.perf_counter()
    common = dict(n=cfg.n_vis, outfile=args.output, config=cfg,
                  subgrid=args.subgrid, fov_pad=args.fov_pad, device=device)
    try:
        if args.mode == "predict":
            if args.aterms:
                phase = "aw_predict"
                pred, peak = ds.aw_predict(akern_path, vis_path, args.model,
                                           **common)
            else:
                phase = "idg_predict"
                pred, peak = ds.idg_predict(vis_path, args.model, **common)
            result = (f"predicted {pred.shape[0]} visibilities, peak "
                      f"|vis|: {peak}")
        elif args.mode == "aw":
            phase = "aw_gridding"
            mx, _ = ds.aw_gridding(akern_path, vis_path, idg=True,
                                   **common)
            result = f"image max: {mx}"
        else:
            phase = "idg_gridding"
            mx, _ = ds.idg_gridding(vis_path, **common)
            result = f"image max: {mx}"
    except (FileNotFoundError, ValueError, KeyError,
            NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.dump_phases:
        print(f"phase {phase} (read + compute + write): "
              f"{time.perf_counter() - t0:.3f} s on {device}")
    print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
