"""Command-line interface of the port (the ``--mode aw [--idg]``, ``--mode
w``, ``--mode idg``, ``--mode predict [--idg [--aterms]]`` and
``--make-data`` surfaces of ``ska_sdp_tpu/cli.py``, same flag names,
defaults and messages).

Examples:
    python -m ska_sdp_tpu_torch.cli --make-data data/ --nant 16 --ntime 24
    python -m ska_sdp_tpu_torch.cli -i data/ --all -o aw.h5   # --mode aw
    python -m ska_sdp_tpu_torch.cli --mode w -i data/ --all -o w.h5
    python -m ska_sdp_tpu_torch.cli --mode predict -i data/ --all \
        --model w.h5 -o pred.h5
    python -m ska_sdp_tpu_torch.cli --mode idg -i data/ --all -o img.h5
    python -m ska_sdp_tpu_torch.cli --mode idg -i data/ --all --device cpu
    python -m ska_sdp_tpu_torch.cli --mode idg --device-phases -i data/ --all
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
                   help="input directory (reads vis.h5, wkern.h5 for --mode "
                        "w, --mode aw and --mode predict without --idg, and "
                        "akern.h5 for --mode aw and --aterms)")
    p.add_argument("-o", "--output", default=None,
                   help="output .h5 (/img, or /vis/model for predict)")
    p.add_argument("--mode", choices=_MODES, default="aw",
                   help="pipeline; ported: aw (fused AW-projection, or "
                        "IDG-AW with --idg), w (bank w-projection), idg "
                        "(image-domain gridding) and predict (model image "
                        "-> vis: bank w-projection, or IDG / IDG-AW "
                        "degridding with --idg)")
    p.add_argument("--subgrid", type=int, default=64,
                   help="IDG subgrid size: any even S up to 128 with "
                        "support 15 <= S/2+1 (32, 64 and 128 take the "
                        "streamed kernels where they fit, the rest the "
                        "fixed-tile kernels); IDG-AW: 32, 64 or 128")
    p.add_argument("--fov-pad", type=float, default=None,
                   help="IDG full-FOV guarantee: grid FOV/f and crop")
    p.add_argument("--precision", choices=["single", "double"],
                   default="single",
                   help="single (complex64, the CUDA kernels) or double "
                        "(complex128; --mode w, aw and predict on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the CUDA kernels) or cpu "
                        "(their plain versions)")
    # accepted for the reference's command lines and not used: its old
    # and new AW schedulings give the same image
    p.add_argument("-old", "--old", action="store_true",
                   help="old AW gridder scheduling (the same image)")
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
                   help="--mode idg: run the pipeline as separately "
                        "synchronised stages and print each stage's time "
                        "(other modes: not yet ported)")
    p.add_argument("--dump-intermediates", metavar="FILE", default=None,
                   help="--mode w debug dumps (not yet ported)")
    p.add_argument("--checkpoint", default=None,
                   help="resumable --mode w run (not yet ported)")
    p.add_argument("--out-of-core", action="store_true",
                   help="streamed --mode w run (not yet ported)")
    p.add_argument("--idg", action="store_true",
                   help="use the IDG realization for --mode predict "
                        "(continuous-w degridding) or --mode aw (IDG-AW: "
                        "image-domain A-screens on pair-chunked subgrids); "
                        "no wkern file needed either way")
    p.add_argument("--aterms", action="store_true",
                   help="--mode predict --idg: apply direction-dependent "
                        "antenna terms from akern.h5 (IDG-AW degridding)")
    p.add_argument("--model", default=None,
                   help="model image .h5 (/img) for --mode predict")
    # synthetic-data generation
    p.add_argument("--make-data", metavar="DIR", default=None,
                   help="write a synthetic DIR/vis.h5, DIR/wkern.h5 and "
                        "DIR/akern.h5 and exit")
    p.add_argument("--nant", type=int, default=16)
    p.add_argument("--ntime", type=int, default=24)
    p.add_argument("--nw", type=int, default=16,
                   help="--make-data: w-kernel bank planes")
    p.add_argument("--qpx", type=int, default=4,
                   help="--make-data: w-kernel oversampling")
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
                              nw_planes=args.nw, qpx=args.qpx,
                              nchan=args.nchan, chan_bw=args.chan_bw)
        paths, obs = generate_dataset(args.make_data, cfg)
        print(f"wrote {paths} ({obs['n']} visibilities)")
        return 0

    if args.mode not in ("w", "idg", "aw", "predict"):
        return _not_ported(f"--mode {args.mode}")
    for flag, on in (("--channels", args.channels not in (None, 1)),
                     ("--distributed", args.distributed),
                     ("--device-phases",
                      args.device_phases and args.mode != "idg"),
                     ("--dump-intermediates", args.dump_intermediates),
                     ("--checkpoint", args.checkpoint),
                     ("--out-of-core", args.out_of_core)):
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
    from .utils.timing import PhaseTimer

    vis_path = os.path.join(args.input_dir, "vis.h5")
    wkern_path = os.path.join(args.input_dir, "wkern.h5")
    akern_path = os.path.join(args.input_dir, "akern.h5")
    w_bank = args.mode == "w" or (args.mode == "predict" and not args.idg)
    required = [vis_path]
    if w_bank or (args.mode == "aw" and not args.idg):
        required.append(wkern_path)
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
    common = dict(n=cfg.n_vis, outfile=args.output, config=cfg, device=device)
    idg_opts = dict(subgrid=args.subgrid, fov_pad=args.fov_pad)
    try:
        if args.mode == "predict":
            if w_bank:
                phase = "w_predict"
                pred, peak = ds.w_predict(wkern_path, vis_path, args.model,
                                          **common)
            elif args.aterms:
                phase = "aw_predict"
                pred, peak = ds.aw_predict(akern_path, vis_path, args.model,
                                           **common, **idg_opts)
            else:
                phase = "idg_predict"
                pred, peak = ds.idg_predict(vis_path, args.model, **common,
                                            **idg_opts)
            result = (f"predicted {pred.shape[0]} visibilities, peak "
                      f"|vis|: {peak}")
        elif w_bank:
            phase = "w_gridding"
            mx, _ = ds.w_gridding(wkern_path, vis_path, **common)
            result = f"image max: {mx}"
        elif args.mode == "aw":
            phase = "aw_gridding"
            opts = idg_opts if args.idg else {}
            mx, _ = ds.aw_gridding(None if args.idg else wkern_path,
                                   akern_path, vis_path, idg=args.idg,
                                   **common, **opts)
            result = f"image max: {mx}"
        else:
            phase = "idg_gridding"
            # None (not False) keeps the SKA_SDP_TPU_DUMP_PHASES fallback
            timer = PhaseTimer(
                enabled=(args.dump_phases or args.device_phases) or None)
            mx, _ = ds.idg_gridding(vis_path, **common, **idg_opts,
                                    timer=timer,
                                    device_phases=args.device_phases)
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
