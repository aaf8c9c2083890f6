"""Command-line interface of the port (the ``--mode aw [--idg]``, ``--mode
w``, ``--mode idg``, ``--mode predict [--idg [--aterms]]``, ``--mode
simple|conv|wcache``, ``--channels N`` and ``--make-data`` surfaces of
``ska_sdp_tpu/cli.py``, same flag names, defaults and messages).

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
    python -m ska_sdp_tpu_torch.cli --mode aw --idg --subgrid 48 -i data/ \
        --all -o aw48.h5
    python -m ska_sdp_tpu_torch.cli --mode wcache -i data/ --all -o wc.h5 \
        --wstep 2000                   # also --mode conv, --mode simple
    python -m ska_sdp_tpu_torch.cli --mode predict --idg --aterms -i data/ \
        --all --model aw.h5 -o pred.h5
    python -m ska_sdp_tpu_torch.cli --make-data data/ --nchan 4
    python -m ska_sdp_tpu_torch.cli --mode idg --channels 4 -i data/ --all \
        -o cube.h5                     # also --mode w, --mode aw --idg
    python -m ska_sdp_tpu_torch.cli --mode w -i data/ --all \
        --checkpoint run.ckpt --slab 100 [--out-of-core]
    python -m ska_sdp_tpu_torch.cli --mode aw --idg --device-phases \
        -i data/ --all                 # also --mode w, --mode aw
    python -m ska_sdp_tpu_torch.cli --mode w -i data/ --all \
        --dump-intermediates dbg.h5 --metrics m.jsonl
    SKA_SDP_TPU_COORDINATOR=127.0.0.1:29500 SKA_SDP_TPU_NPROCS=2 \
    SKA_SDP_TPU_PROC_ID=0 python -m ska_sdp_tpu_torch.cli --distributed \
        --mode w -i data/ --all -o w.h5   # and PROC_ID=1 beside it
    python -m ska_sdp_tpu_torch.cli --distributed --mode idg --channels 4 \
        -i data/ --all                 # one process: a world of one

Every flag of the reference parses, and every mode runs.  Flags that are
not ported (``--gridder``, ``--xla-dump``, ``--backend tpu``) exit with
status 2 and a "not yet ported" message; ``--backend cpu`` is ``--device
cpu``.  ``--distributed`` serves ``--mode w``, ``--mode idg`` and
``--mode idg --channels N``, as the reference does; other modes exit 1.
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
                   help="pipeline: aw (fused AW-projection, or IDG-AW "
                        "with --idg), w (bank w-projection), idg "
                        "(image-domain gridding), predict (model image -> "
                        "vis: bank w-projection, or IDG / IDG-AW degridding "
                        "with --idg), and the PSF-normalised simple "
                        "(nearest cell), conv (one kernel at the mean |w|) "
                        "and wcache (a bank binned by --wstep)")
    p.add_argument("--subgrid", type=int, default=64,
                   help="IDG subgrid size: any even S up to 128 with "
                        "support 15 <= S/2+1 (32, 64 and 128 take the "
                        "streamed kernels' run prep where it fits, the rest "
                        "the fixed-tile prep on the same kernels); IDG-AW: "
                        "any even S up to 128 that leaves a taper fit "
                        "margin (S >= 28 with support 15)")
    p.add_argument("--fov-pad", type=float, default=None,
                   help="IDG full-FOV guarantee: grid FOV/f and crop")
    p.add_argument("--precision", choices=["single", "double"],
                   default="single",
                   help="single (complex64, the CUDA kernels) or double "
                        "(complex128: on the CPU wherever a CUDA kernel "
                        "runs)")
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
    p.add_argument("--channels", type=int, default=None,
                   help="image N spectral channels, each at its own "
                        "frequency (modes w, idg, aw --idg); record binning "
                        "is shared per channel group; writes /img (channel "
                        "mean) + /img_cube [nch, n, n]")
    p.add_argument("--backend", choices=["tpu", "cpu"], default=None,
                   help="the reference's device switch: cpu is --device "
                        "cpu; tpu is not ported")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace (Chrome JSON) of each "
                        "timed phase here")
    # reference flags of surfaces not ported yet
    p.add_argument("--gridder", choices=["auto", "xla", "pallas"],
                   default=None,
                   help="the reference's gridder selector (not ported: one "
                        "route per mode)")
    p.add_argument("--wstep", type=float, default=2000.0,
                   help="w-bin width for --mode wcache (ref default 2000)")
    p.add_argument("--metrics", default=None,
                   help="append structured JSON-lines metrics to this file "
                        "(run/start, and run/done with the phases and "
                        "counters)")
    p.add_argument("--xla-dump", default=None, metavar="DIR",
                   help="the reference's compiler dumps (not ported)")
    p.add_argument("--slab", type=int, default=1 << 20,
                   help="visibilities per checkpoint slab (one bank scatter "
                        "launch and one checkpoint write each)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-device imaging (modes w, idg and idg "
                        "--channels N), one process a device; the group "
                        "from SKA_SDP_TPU_COORDINATOR/_NPROCS/_PROC_ID, "
                        "NCCL on cuda, gloo on cpu")
    p.add_argument("--device-phases", action="store_true",
                   help="run the pipeline as separately synchronised stages "
                        "and print each stage's device time (modes w, idg, "
                        "aw and aw --idg); implies -dphases")
    p.add_argument("--dump-intermediates", metavar="FILE", default=None,
                   help="write the pipeline intermediates (uv-grid planes, "
                        "w-planes, image) to FILE's /debug tree (--mode w)")
    p.add_argument("--checkpoint", default=None,
                   help="resumable run: checkpoint .h5 path (--mode w)")
    p.add_argument("--out-of-core", action="store_true",
                   help="stream visibility slabs from disk with background "
                        "prefetch (requires --checkpoint; --mode w)")
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


def _all_counters(timer) -> dict:
    """The timer's counters and the records each gridder dropped, under
    ``dropped/<gridder>``.  The reference also reports its Pallas→XLA
    downgrades as ``fallback/*``; the port has no such fallback (a kernel
    that fails to build or launch raises), so it has no such keys."""
    from . import kernels

    out = dict(timer.counters)
    for k, v in kernels.drop_counters().items():
        out[f"dropped/{k}"] = float(v)
    return out


def _not_ported(what: str) -> int:
    print(f"error: {what} is not yet ported to ska_sdp_tpu_torch "
          "(use ska_sdp_tpu)", file=sys.stderr)
    return 2


def _dispatch_distributed(args, cfg, timer, metrics, vis_path, wkern_path,
                          device) -> int:
    """``--distributed``: the sharded steps (``parallel/``), one process a
    device.  The process group comes from the SKA_SDP_TPU_COORDINATOR /
    _NPROCS / _PROC_ID environment (a world of one without it), on NCCL
    for ``--device cuda`` and gloo for ``--device cpu``; the mesh is
    ``("host", "vis")`` over several processes, ``("vis",)`` over one.
    Serves ``--mode w``, ``--mode idg`` and ``--mode idg --channels N``;
    only rank 0 writes.  The group is destroyed on the way out."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from .parallel import initialize, make_host_vis_mesh, make_mesh

    initialize(device=device)
    try:
        nproc = dist.get_world_size()
        mesh = (make_host_vis_mesh(device=device) if nproc > 1
                else make_mesh(device=device))
        print(f"distributed: {nproc} process(es), {mesh.size} device(s), "
              f"mesh axes {mesh.axis_names}", flush=True)
        out = args.output if mesh.rank == 0 else None
        if args.mode == "idg" and args.channels is not None \
                and args.channels > 1:
            from .models import spectral

            mx, _img, cube = spectral.idg_gridding_multi_sharded(
                vis_path, args.channels, n=cfg.n_vis, outfile=out,
                config=cfg, timer=timer, subgrid=args.subgrid, mesh=mesh)
            print(f"imaged {cube.shape[0]} channels (sharded over "
                  f"{mesh.size} devices), continuum image max: {mx}")
            metrics.emit("run/done", image_max=mx,
                         channels=int(cube.shape[0]), phases=timer.times,
                         counters=_all_counters(timer))
            return 0
        if args.mode not in ("w", "idg"):
            print("error: --distributed supports --mode w, --mode idg and "
                  "--mode idg --channels N", file=sys.stderr)
            return 1

        from .io.inputs import get_wkernels
        from .models.dataset import bank_tensors
        from .models.runs import write_image
        from .parallel import (load_vis_sharded, make_sharded_idg_step,
                               make_sharded_wproj_step)

        with timer.phase("ingest/vis-sharded"):
            uvw, vis, freq = load_vis_sharded(vis_path, mesh, n=cfg.n_vis,
                                              precision=cfg.precision)
        theta, lam = cfg.grid.theta, cfg.grid.lam
        with timer.phase("compile+grid+fft"):
            if args.mode == "w":
                with timer.phase("ingest/wkern"):
                    wkerns, wbins = get_wkernels(wkern_path, theta)
                bank, centers = bank_tensors(wkerns, wbins, cfg.precision,
                                             mesh.device)
                img = make_sharded_wproj_step(mesh, theta, lam)(
                    torch.conj(bank).resolve_conj(), centers, uvw, freq, vis)
            else:
                img = make_sharded_idg_step(mesh, theta, lam,
                                            subgrid=args.subgrid)(uvw, freq,
                                                                  vis)
            img = img.cpu().numpy()
        mx = float(np.max(img))
        write_image(out, img, timer)
        print(f"image max: {mx}")
        metrics.emit("run/done", image_max=mx, phases=timer.times,
                     counters=_all_counters(timer))
        return 0
    finally:
        dist.destroy_process_group()


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

    for flag, on in (("--backend tpu", args.backend == "tpu"),
                     ("--gridder", args.gridder),
                     ("--xla-dump", args.xla_dump)):
        if on:
            return _not_ported(flag)
    from .utils.metrics import MetricsSink

    metrics = MetricsSink(args.metrics)
    metrics.emit("run/start", mode=args.mode, n=args.n, all=args.all)
    multichannel = args.channels is not None and args.channels > 1
    if args.aterms and not (args.mode == "predict" and args.idg):
        print("error: --aterms requires --mode predict --idg",
              file=sys.stderr)
        return 1
    if args.mode == "predict" and not args.model and not multichannel:
        print("error: --mode predict requires --model", file=sys.stderr)
        return 1

    import torch

    from .config import GridParams, ImagingConfig
    from .models import runs, spectral
    from .models.imaging import PSF_MODES
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
    if multichannel and not (args.mode in ("idg", "w")
                             or (args.mode == "aw" and args.idg)):
        print("error: --channels supports --mode w, --mode idg and "
              "--mode aw --idg", file=sys.stderr)
        return 1
    device = torch.device("cpu" if args.backend == "cpu" else args.device)
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
    # None (not False) keeps the SKA_SDP_TPU_DUMP_PHASES fallback; the
    # phases wait for the card where --metrics reports them
    timer = PhaseTimer(enabled=(args.dump_phases or args.device_phases)
                       or None, trace_dir=args.trace_dir,
                       wait=bool(args.metrics) or None)
    common["timer"] = timer
    if args.distributed:
        try:
            return _dispatch_distributed(args, cfg, timer, metrics, vis_path,
                                         wkern_path, device)
        except (FileNotFoundError, ValueError, KeyError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    done = {}                   # the run/done event's result fields
    if args.mode == "w" and not multichannel:
        if args.checkpoint and (args.device_phases
                                or args.dump_intermediates):
            print("warning: --device-phases/--dump-intermediates are not "
                  "supported on the checkpointed/out-of-core paths "
                  "(ignored)", file=sys.stderr)
        if args.out_of_core and not args.checkpoint:
            print("error: --out-of-core requires --checkpoint",
                  file=sys.stderr)
            return 1

    try:
        if multichannel:
            if args.mode == "idg":
                phase = "idg_gridding_multi"
                mx, _, cube = spectral.idg_gridding_multi(
                    vis_path, args.channels, **common, **idg_opts)
            elif args.mode == "aw":
                phase = "aw_idg_gridding_multi"
                mx, _, cube = spectral.aw_idg_gridding_multi(
                    akern_path, vis_path, args.channels, **common,
                    **idg_opts)
            else:
                phase = "w_gridding_multi"
                mx, _, cube = spectral.w_gridding_multi(
                    wkern_path, vis_path, args.channels, **common)
            result = (f"imaged {cube.shape[0]} channels, continuum image "
                      f"max: {mx}")
            done = dict(image_max=mx, channels=int(cube.shape[0]))
        elif args.mode == "predict":
            if w_bank:
                phase = "w_predict"
                pred, peak = runs.w_predict(wkern_path, vis_path, args.model,
                                            **common)
            elif args.aterms:
                phase = "aw_predict"
                pred, peak = runs.aw_predict(akern_path, vis_path, args.model,
                                             **common, **idg_opts)
            else:
                phase = "idg_predict"
                pred, peak = runs.idg_predict(vis_path, args.model, **common,
                                              **idg_opts)
            result = (f"predicted {pred.shape[0]} visibilities, peak "
                      f"|vis|: {peak}")
            done = dict(peak_vis=peak)
        else:
            if args.mode in PSF_MODES:
                phase = "psf_gridding"
                mx, _ = runs.psf_gridding(args.mode, vis_path, **common,
                                          wstep=args.wstep)
            elif w_bank and args.checkpoint:
                phase = ("w_gridding_out_of_core" if args.out_of_core
                         else "w_gridding_checkpointed")
                mx, _ = getattr(runs, phase)(wkern_path, vis_path,
                                             args.checkpoint, **common,
                                             slab=args.slab)
            elif w_bank:
                phase = "w_gridding"
                mx, _ = runs.w_gridding(
                    wkern_path, vis_path, **common,
                    device_phases=args.device_phases,
                    dump_intermediates=args.dump_intermediates)
            elif args.mode == "aw":
                phase = "aw_gridding"
                opts = idg_opts if args.idg else {}
                mx, _ = runs.aw_gridding(None if args.idg else wkern_path,
                                         akern_path, vis_path, idg=args.idg,
                                         device_phases=args.device_phases,
                                         **common, **opts)
            else:
                phase = "idg_gridding"
                mx, _ = runs.idg_gridding(vis_path, **common, **idg_opts,
                                          device_phases=args.device_phases)
            result = f"image max: {mx}"
            done = dict(image_max=mx)
    except (FileNotFoundError, ValueError, KeyError,
            NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.dump_phases:
        print(f"phase {phase} (read + compute + write): "
              f"{time.perf_counter() - t0:.3f} s on {device}")
    print(result)
    metrics.emit("run/done", **done, phases=timer.times,
                 counters=_all_counters(timer))
    return 0


if __name__ == "__main__":
    sys.exit(main())
