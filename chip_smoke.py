#!/usr/bin/env python3
"""Chip smoke test of ska_sdp_tpu_torch: the ``--mode idg`` imaging path
end to end on one NVIDIA GPU, through the hand-written CUDA gridder.

    python3 chip_smoke.py

Phases (each failure raises; the script then exits non-zero and prints no
result line):

1. device: a CUDA card is required (no CPU fallback); versions and the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build: compile ``ska_sdp_tpu_torch/csrc/idg_grid.cu`` with nvcc for
   sm_90a and print the build time and ptxas resource use;
3. kernel parity on the card against the plain PyTorch version on the same
   inputs: a mid-size IDG-AW case (512² grid, S=64, 16 antennas of track
   data, random screens) and the full-size unit-screen records of the main
   path; grid rel-L2 ≤ 5e-5 and equal ``n_dropped``;
4. main path: a synthetic SKA1-Low observation (512 stations, 8 times,
   seed 1234: 1,046,528 visibilities) imaged by ``idg_image`` on a 2400²
   grid (θ=0.008, lam=300000, S=64, support 15, β=12) with the kernel's
   launch count reset just before; checks a finite image, no drops, at
   least one launch, the peak at a simulated source, every source's 5×5
   window above 0.25·max, and image rel-L2 ≤ 1e-4 over the central 75%
   against the same pipeline with the plain gridder on the card;
5. times (CUDA events, median of 7 after a warm-up): the kernel, its plain
   version, the run prep, and ``idg_image`` end to end.

The line before last is the ``nvidia-smi`` name and power limit, the one
before it a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
THETA, LAM, SUBGRID, SUPPORT, BETA = 0.008, 300000, 64, 15, 12.0
KERNEL_TOL = 5e-5        # the reference's between-route grid bound
IMAGE_TOL = 1e-4         # image contract over the central 75%
REPS = 7


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def crop75(a):
    n = a.shape[0]
    return a[n // 8:n - n // 8, n // 8:n - n // 8]


def timed_ms(torch, fn, reps=REPS):
    """Median milliseconds of ``fn()`` on the card (CUDA events, one
    warm-up run)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main() -> int:
    import torch

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("error: no CUDA device visible; this smoke test runs only on "
              "a GPU", file=sys.stderr)
        return 1
    import ska_sdp_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(ska_sdp_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        raise RuntimeError(f"ska_sdp_tpu_torch imported from {pkg_dir}, not "
                           f"from this checkout ({HERE})")
    from ska_sdp_tpu_torch.io.synthetic import (SyntheticConfig,
                                                simulate_observation)
    from ska_sdp_tpu_torch.kernels import _build, _idg_unit_run_bound
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.kernels.idg_aw_records import idg_aw_run_records
    from ska_sdp_tpu_torch.models.dataset import (_idg_finish, idg_grid_inputs,
                                                  idg_image, idg_inputs,
                                                  vis_data_from_observation)
    from ska_sdp_tpu_torch.ops import mirror_uvw, uvw_lambda
    from ska_sdp_tpu_torch.ops.idg_aw import aw_screens_host

    dev = torch.device("cuda", 0)
    card = smi()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"device: {name} (count {torch.cuda.device_count()})")
    print(f"nvidia-smi: {card}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load("idg_grid")
    print(f"build: idg_grid.cu for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.get("idg_grid", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    def rr(shape, p, a1, a2, w, vis, max_runs, nant):
        return idg_aw_run_records(shape, p, a1, a2, w, vis.real, vis.imag,
                                  subgrid=SUBGRID, support=SUPPORT,
                                  max_runs=max_runs, nant=nant)

    def both(recs, shape, scr, theta):
        k = stream.idg_aw_grid_from_records_stream(
            *recs[:7], shape, scr, theta=theta, subgrid=SUBGRID,
            taper_beta=BETA)
        pl = stream.grid_from_records_plain(
            *recs[:7], scr, grid_shape=shape, theta=theta, subgrid=SUBGRID,
            taper_beta=BETA)[SUBGRID:SUBGRID + shape[0],
                             SUBGRID:SUBGRID + shape[1]]
        torch.cuda.synchronize()
        return k, pl

    # ---- 3a. mid-size IDG-AW parity ---------------------------------------
    mid_lam = 64000                                     # 512² at θ=0.008
    obs = simulate_observation(SyntheticConfig(theta=THETA, lam=mid_lam,
                                               nant=16, ntime=256, seed=7))
    vd = vis_data_from_observation(obs)
    uvw, f, vis = idg_inputs(vd, device=dev)
    uvw1, vis1 = mirror_uvw(uvw_lambda(f, uvw), vis)
    a1 = torch.as_tensor(vd.antenna1, device=dev)
    a2 = torch.as_tensor(vd.antenna2, device=dev)
    rng = np.random.default_rng(7)
    ak = np.zeros((16, 5, 5), np.complex128)
    ak[:, 2, 2] = 1.0
    ak += 0.05 * (rng.standard_normal((16, 5, 5))
                  + 1j * rng.standard_normal((16, 5, 5)))
    scr = torch.as_tensor(aw_screens_host(ak, SUBGRID).astype(np.complex64),
                          device=dev)
    shape = (512, 512)
    recs = rr(shape, uvw1 / mid_lam, a1, a2, uvw1[:, 2], vis1, 65536, 16)
    k, pl = both(recs, shape, scr, THETA)
    err = rel_l2(k.cpu().numpy(), pl.cpu().numpy())
    nd = int(recs[7])
    print(f"parity mid (512², S=64, 16 ant, {vis.shape[0]} vis, random "
          f"screens): rel-L2 {err:.3e} (bound {KERNEL_TOL}), n_dropped "
          f"kernel {nd} plain {nd}")
    if not err <= KERNEL_TOL or nd != 0:
        raise AssertionError(f"mid-size kernel parity failed: {err}, {nd}")

    # ---- 3b. full-size unit-screen parity (the main path's records) ------
    obs = simulate_observation(SyntheticConfig(theta=THETA, lam=LAM,
                                               nant=512, ntime=8, seed=1234))
    vd = vis_data_from_observation(obs)
    n_vis = vd.vis.shape[0]
    uvw, f, vis = idg_inputs(vd, device=dev)
    g = idg_grid_inputs(uvw, f, vis, theta=THETA, lam=LAM)
    zer = torch.zeros((n_vis,), dtype=torch.int32, device=dev)
    unit = torch.ones((1, SUBGRID, SUBGRID), dtype=torch.complex64,
                      device=dev)
    max_runs = _idg_unit_run_bound(g.grid_shape, SUBGRID, SUPPORT)
    recs = rr(g.grid_shape, g.p, zer, zer, g.w, g.vis, max_runs, 1)
    n_runs = int((recs[2] > recs[1]).sum())
    k_full, pl_full = both(recs, g.grid_shape, unit, g.theta)
    kf, pf = k_full.cpu().numpy(), pl_full.cpu().numpy()
    err_full = rel_l2(kf, pf)
    max_abs = float(np.abs(kf - pf).max())
    nd_full = int(recs[7])
    print(f"parity full ({g.grid_shape[0]}², S=64, {n_vis} vis, "
          f"{n_runs} runs of {max_runs}, unit screens): rel-L2 "
          f"{err_full:.3e} (bound {KERNEL_TOL}), max |err| {max_abs:.3e}, "
          f"n_dropped kernel {nd_full} plain {nd_full}")
    if not err_full <= KERNEL_TOL or nd_full != 0:
        raise AssertionError(f"full-size kernel parity failed: {err_full}")

    # ---- 4. main path -----------------------------------------------------
    stream.reset_launch_count()
    res = idg_image(vd, theta=THETA, lam=LAM, subgrid=SUBGRID,
                    taper_beta=BETA, device=dev)
    torch.cuda.synchronize()
    launches = stream.launch_count()
    img = res.image.cpu().numpy()
    n = img.shape[0]
    print(f"main path: idg_image {n}² from {n_vis} vis, image max "
          f"{res.image_max:.6g}, n_dropped {res.n_dropped}, kernel launches "
          f"{launches}")
    if not np.isfinite(img).all():
        raise AssertionError("image has non-finite pixels")
    if res.n_dropped != 0:
        raise AssertionError(f"{res.n_dropped} records dropped")
    if launches < 1:
        raise AssertionError("the main path did not launch the CUDA kernel")
    iy, ix = np.unravel_index(np.argmax(img), img.shape)
    srcs = obs["sources"]
    dists = [abs(iy - (n / 2 + m * LAM)) + abs(ix - (n / 2 + l * LAM))
             for l, m, _ in srcs]
    print(f"  peak at ({iy}, {ix}), L1 distance to nearest source "
          f"{min(dists):.2f} px (bound 3)")
    if min(dists) > 3.0:
        raise AssertionError("image peak is not at a simulated source")
    for l, m, flux in srcs:
        cy, cx = int(round(n / 2 + m * LAM)), int(round(n / 2 + l * LAM))
        win = img[max(0, cy - 2):cy + 3, max(0, cx - 2):cx + 3]
        print(f"  source ({l:+.5f}, {m:+.5f}) flux {flux:.3f}: window max "
              f"{win.max() / img.max():.3f} of image max (bound 0.25)")
        if not win.max() > 0.25 * img.max():
            raise AssertionError(f"source at ({l}, {m}) not recovered")
    img_plain = _idg_finish(pl_full, g.n, g.grid_shape[0], g.crop_lo,
                            SUBGRID, BETA).cpu().numpy()
    err_img = rel_l2(crop75(img), crop75(img_plain))
    print(f"  image vs plain-gridder pipeline: rel-L2 {err_img:.3e} over "
          f"the central 75% (bound {IMAGE_TOL})")
    if not err_img <= IMAGE_TOL:
        raise AssertionError(f"image parity failed: {err_img}")

    # ---- 5. times -----------------------------------------------------------
    ms_kernel = timed_ms(torch, lambda: stream.idg_aw_grid_from_records_stream(
        *recs[:7], g.grid_shape, unit, theta=g.theta, subgrid=SUBGRID,
        taper_beta=BETA))
    ms_plain = timed_ms(torch, lambda: stream.grid_from_records_plain(
        *recs[:7], unit, grid_shape=g.grid_shape, theta=g.theta,
        subgrid=SUBGRID, taper_beta=BETA))
    ms_prep = timed_ms(torch, lambda: rr(g.grid_shape, g.p, zer, zer, g.w,
                                         g.vis, max_runs, 1))
    ms_e2e = timed_ms(torch, lambda: idg_image(
        vd, theta=THETA, lam=LAM, subgrid=SUBGRID, taper_beta=BETA,
        device=dev))
    for label, ms in (("gridder kernel (CUDA)", ms_kernel),
                      ("gridder plain (PyTorch)", ms_plain),
                      ("run prep (sort + CSR)", ms_prep),
                      ("idg_image end to end", ms_e2e)):
        print(f"time {label}: {ms:.3f} ms = {n_vis / ms / 1e3:.2f} M vis/s "
              f"[{card}]")

    print(json.dumps({"kernels": [{
        "name": "idg_grid_stream",
        "route": "cuda",
        "source": "ska_sdp_tpu_torch/csrc/idg_grid.cu",
        "replaces": "ska_sdp_tpu/kernels/idg_aw_stream_pallas.py:161",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
