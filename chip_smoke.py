#!/usr/bin/env python3
"""Chip smoke test of ska_sdp_tpu_torch: the ported imaging and prediction
paths end to end on one NVIDIA GPU, through the hand-written CUDA gridder
and degridder.

    python3 chip_smoke.py

Phases (each failure raises; the script then exits non-zero and prints no
result line):

1. device: a CUDA card is required (no CPU fallback); versions and the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build: compile ``ska_sdp_tpu_torch/csrc/idg_grid.cu`` and
   ``csrc/idg_degrid.cu`` with nvcc for sm_90a, one nvcc each, started
   together; print the gridder's build time and ptxas resource use;
3. gridder parity on the card against the plain PyTorch version on the
   same inputs: a mid-size IDG-AW case (512² grid, S=64, 16 antennas of
   track data, random screens) and the full-size unit-screen records of the
   main path; grid rel-L2 ≤ 5e-5 and equal ``n_dropped``;
4. IDG imaging main path: a synthetic SKA1-Low observation (512 stations,
   8 times, seed 1234: 1,046,528 visibilities) imaged by ``idg_image`` on a
   2400² grid (θ=0.008, lam=300000, S=64, support 15, β=12) with the launch
   counts reset just before; checks a finite image, no drops, at least one
   gridder launch, the peak at a simulated source, every source's 5×5
   window above 0.25·max, and image rel-L2 ≤ 1e-4 over the central 75%
   against the same pipeline with the plain gridder on the card;
5. gridder times (CUDA events, median of 7 after a warm-up): the kernel,
   its plain version, the run prep, and ``idg_image`` end to end;
6. build: the degridder's build time and ptxas resource use;
7. degridder parity on the card against its plain version: the mid-size
   IDG-AW case of phase 3 degridding a random grid, and the full-size
   unit-screen records degridding phase 3's grid; predicted-visibility
   rel-L2 ≤ 5e-5 and equal ``n_dropped``;
8. IDG predict main path: a 2400² model of phase 4's five sources, each
   snapped to a pixel centre, through ``idg_predict_vis`` with the launch
   counts reset just before; checks finite output, no drops, at least one
   degridder launch, and rel-L2 ≤ 2e-4 against a float64 direct DFT of the
   snapped sources on the card (max |err| per unit total flux printed);
9. IDG-AW imaging and predict at the reference benchmark's IDG-AW shape
   (64 stations, 2016 baselines, 65 times, 8 channels: 1,048,320 track
   records from seed 11, pair-major; random complex 15×15 A-kernels;
   2400², S=64),
   entering ``aw_idg_image`` and ``aw_predict_vis`` as uvw = p·lam metres
   at frequency c; the predict model is the phase's own image inside the
   central 75%.  Each path runs with the launch counts reset just before;
   checks 0 dropped both ways, at least one launch of its kernel, the
   image within rel-L2 1e-4 (central 75%) of the same pipeline on the plain
   gridder, and the predictions within 5e-5 of the plain degridder;
   9b. band fold: the reference's banded 4800² shape (θ=0.016, 64
   stations, 520 times: 1,048,320 records, random w, unit screens,
   ``max_runs = 16·nbl + n/128 + 64``) gridded and degridded through both
   kernels, 0 dropped and each within 5e-5 of its plain version;
10. degridder times (CUDA events, median of 7 after a warm-up): the
    kernel, its plain version, the degrid prep, and IDG predict, IDG-AW
    image and IDG-AW predict end to end.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
THETA, LAM, SUBGRID, SUPPORT, BETA = 0.008, 300000, 64, 15, 12.0
KERNEL_TOL = 5e-5        # the reference's between-route bound
IMAGE_TOL = 1e-4         # image contract over the central 75%
TRUTH_TOL = 2e-4         # predict vs direct DFT (the reference's IDG bound)
C = 299792458.0
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


def print_ptxas(build_log, name):
    for line in build_log.get(name, "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def track_records(nbl, ntime, nchan, n_grid, rng):
    """Baseline tracks as the reference benchmark builds them: per-baseline
    uv drift over ``ntime`` samples, channels inner.  Returns ``(p [n, 3]
    float32 with w in p[:, 2], time-major pair indices)``."""
    u0 = rng.uniform(-0.40, 0.40, (nbl, 2))
    du = rng.uniform(-30.0 / n_grid, 30.0 / n_grid, (nbl, 2))
    w0 = rng.uniform(-3800.0, 3800.0, nbl)
    dw = rng.uniform(-100.0, 100.0, nbl)
    ft = (np.arange(ntime) / ntime)[:, None, None]
    fs = (1.0 + 0.0005 * np.arange(nchan))[None, None, :]
    ut = (u0[None, :, 0:1] + du[None, :, 0:1] * ft) * fs
    vt = (u0[None, :, 1:2] + du[None, :, 1:2] * ft) * fs
    wt = (w0[None, :, None] + dw[None, :, None] * ft) * np.ones_like(fs)
    p = np.zeros((ut.size, 3), np.float32)
    p[:, 0] = ut.ravel()
    p[:, 1] = vt.ravel()
    p[:, 2] = wt.ravel()
    return p, ut.shape


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

    # ---- 2. build (both kernels at once) ----------------------------------
    def build(kernel):
        t = time.perf_counter()
        _build.load(kernel)
        return time.perf_counter() - t

    pool = ThreadPoolExecutor(max_workers=2)
    builds = {k: pool.submit(build, k) for k in ("idg_grid", "idg_degrid")}
    pool.shutdown(wait=False)
    print(f"build: idg_grid.cu for sm_90a in "
          f"{builds['idg_grid'].result():.1f} s")
    print_ptxas(_build.build_log, "idg_grid")

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
    mid = dict(shape=shape, p=uvw1 / mid_lam, a1=a1, a2=a2, w=uvw1[:, 2],
               scr=scr, n=vis.shape[0])

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
    launches = stream.launch_count(stream.GRID_KERNEL)
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

    # ---- 6.-10. the degridder and the predict and IDG-AW paths ------------
    print(f"build: idg_degrid.cu for sm_90a in "
          f"{builds['idg_degrid'].result():.1f} s (started with idg_grid.cu)")
    print_ptxas(_build.build_log, "idg_degrid")
    degrid = degrid_phases(torch, dev, card, mid, vd, obs, k_full)

    print(json.dumps({"kernels": [{
        "name": stream.GRID_KERNEL,
        "route": "cuda",
        "source": "ska_sdp_tpu_torch/csrc/idg_grid.cu",
        "replaces": "ska_sdp_tpu/kernels/idg_aw_stream_pallas.py:161",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
    }, {
        "name": stream.DEGRID_KERNEL,
        "route": "cuda",
        "source": "ska_sdp_tpu_torch/csrc/idg_degrid.cu",
        "replaces": "ska_sdp_tpu/kernels/idg_aw_stream_pallas.py:475",
        **degrid,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def degrid_phases(torch, dev, card, mid, vd, obs, grid_full):
    """Phases 7-10.  ``mid`` holds phase 3a's inputs, ``vd``/``obs`` the
    main path's observation and ``grid_full`` phase 3b's kernel grid.
    Returns the degridder's entry of the ``kernels`` line."""
    from ska_sdp_tpu_torch.kernels import _idg_unit_run_bound
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.kernels.idg_aw_records import (
        idg_aw_degrid_records, idg_aw_run_records)
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.types import SINGLE

    def degrid_both(shape, p, a1, a2, w, grid, scr, theta, max_runs):
        recs = idg_aw_degrid_records(shape, p, a1, a2, w, subgrid=SUBGRID,
                                     support=SUPPORT, max_runs=max_runs)
        kw = dict(theta=theta, subgrid=SUBGRID, taper_beta=BETA)
        k = stream.idg_aw_degrid_from_records_stream(*recs[:7], grid, scr,
                                                     **kw)
        pl = stream.degrid_from_records_plain(*recs[:7], grid, scr, **kw)
        torch.cuda.synchronize()
        return recs, k.cpu().numpy(), pl.cpu().numpy()

    # ---- 7a. mid-size IDG-AW degrid parity --------------------------------
    rng = np.random.default_rng(8)
    shape = mid["shape"]
    grid_mid = torch.as_tensor(
        (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
         ).astype(np.complex64), device=dev)
    recs, k, pl = degrid_both(shape, mid["p"], mid["a1"], mid["a2"],
                              mid["w"], grid_mid, mid["scr"], THETA, 65536)
    err = rel_l2(k, pl)
    nd = int(recs[8])
    print(f"degrid parity mid (512², S=64, 16 ant, {mid['n']} vis, random "
          f"screens, random grid): rel-L2 {err:.3e} (bound {KERNEL_TOL}), "
          f"n_dropped kernel {nd} plain {nd}")
    if not err <= KERNEL_TOL or nd != 0:
        raise AssertionError(f"mid-size degrid parity failed: {err}, {nd}")

    # ---- 7b. full-size unit-screen degrid parity --------------------------
    n_vis = vd.vis.shape[0]
    uvw, f, vis = ds.idg_inputs(vd, device=dev)
    g = ds.idg_grid_inputs(uvw, f, vis, theta=THETA, lam=LAM)
    zer = torch.zeros((n_vis,), dtype=torch.int32, device=dev)
    unit = torch.ones((1, SUBGRID, SUBGRID), dtype=torch.complex64,
                      device=dev)
    mr_unit = _idg_unit_run_bound(g.grid_shape, SUBGRID, SUPPORT)
    drecs_full, kf, pf = degrid_both(g.grid_shape, g.p, zer, zer, g.w,
                                     grid_full, unit, g.theta, mr_unit)
    err_full = rel_l2(kf, pf)
    max_abs = float(np.abs(kf - pf).max())
    nd = int(drecs_full[8])
    print(f"degrid parity full ({g.grid_shape[0]}², S=64, {n_vis} vis, unit "
          f"screens, phase 3 grid): rel-L2 {err_full:.3e} (bound "
          f"{KERNEL_TOL}), max |err| {max_abs:.3e}, n_dropped kernel {nd} "
          f"plain {nd}")
    if not err_full <= KERNEL_TOL or nd != 0:
        raise AssertionError(f"full-size degrid parity failed: {err_full}")

    # ---- 8. IDG predict main path -----------------------------------------
    n = g.n
    model = np.zeros((n, n), np.float32)
    srcs = []
    for l, m, flux in obs["sources"]:
        py, px = int(round(n / 2 + m * LAM)), int(round(n / 2 + l * LAM))
        if not (n // 8 <= min(py, px) and max(py, px) < n - n // 8):
            raise AssertionError("a source lies outside the central 75%")
        model[py, px] += flux
        srcs.append(((px - n // 2) / LAM, (py - n // 2) / LAM, flux))
    stream.reset_launch_count()
    pred = ds.idg_predict_vis(vd, model, theta=THETA, lam=LAM,
                              subgrid=SUBGRID, taper_beta=BETA, device=dev)
    torch.cuda.synchronize()
    launches = stream.launch_count(stream.DEGRID_KERNEL)
    # direct DFT of the snapped sources, float64 on the card
    uvw64 = torch.as_tensor(vd.uvw, dtype=torch.float64, device=dev)
    uvw64 = uvw64 * (vd.frequency / C)
    truth = torch.zeros((n_vis,), dtype=torch.complex128, device=dev)
    for l, m, flux in srcs:
        ph = (uvw64[:, 0] * l + uvw64[:, 1] * m
              + uvw64[:, 2] * (np.sqrt(1.0 - l * l - m * m) - 1.0))
        truth += flux * torch.polar(torch.ones_like(ph), -2.0 * np.pi * ph)
    got = pred.vis.to(torch.complex128)
    err_truth = float(torch.linalg.norm(got - truth)
                      / torch.linalg.norm(truth))
    max_flux = float((got - truth).abs().max()) / sum(s[2] for s in srcs)
    print(f"predict main path: idg_predict_vis {n}² model of {len(srcs)} "
          f"sources to {n_vis} vis, peak |vis| {pred.peak:.6g}, n_dropped "
          f"{pred.n_dropped}, degrid launches {launches}")
    print(f"  vs float64 direct DFT: rel-L2 {err_truth:.3e} (bound "
          f"{TRUTH_TOL}), max |err| per unit total flux {max_flux:.3e}")
    if not torch.isfinite(pred.vis).all():
        raise AssertionError("prediction has non-finite values")
    if pred.n_dropped != 0:
        raise AssertionError(f"{pred.n_dropped} records dropped")
    if launches < 1:
        raise AssertionError("IDG predict did not launch the CUDA degridder")
    if not err_truth <= TRUTH_TOL:
        raise AssertionError(f"predict vs direct DFT failed: {err_truth}")

    # ---- 9. IDG-AW imaging and predict at the benchmark's track shape ----
    nant = 64
    ii, jj = np.triu_indices(nant, k=1)
    nbl = ii.shape[0]
    p_t, tshape = track_records(nbl, 65, 8, n, np.random.default_rng(11))
    nT = p_t.shape[0]
    # pair-major, channels then time inner: each (baseline, channel) track
    # is one segment.  (As a time-major raster of 16,128 "baselines" the
    # 8 channel tracks of a pair would enter the unsorted prep as 8
    # segments each and overflow the 8·npair run bound.)
    pm = np.arange(nT).reshape(tshape).transpose(1, 2, 0).ravel()
    p_t = p_t[pm]
    a1_t = np.broadcast_to(ii[None, :, None], tshape).ravel()[pm]
    a2_t = np.broadcast_to(jj[None, :, None], tshape).ravel()[pm]
    time_t = np.broadcast_to(np.arange(65.0)[:, None, None], tshape
                             ).ravel()[pm]
    rng = np.random.default_rng(12)
    ak = (rng.standard_normal((nant, 15, 15))
          + 1j * rng.standard_normal((nant, 15, 15)))
    uvw_t = np.stack([p_t[:, 0] * LAM, p_t[:, 1] * LAM, p_t[:, 2]], 1)
    vis_t = (rng.standard_normal(nT) + 1j * rng.standard_normal(nT))
    vd_aw = ds.VisData(vis_t, uvw_t.astype(np.float64),
                       a1_t.astype(np.int64), a2_t.astype(np.int64), time_t,
                       C)
    mr = ds._aw_run_bound(vd_aw.antenna1, vd_aw.antenna2, nT)
    layout = ds._detect_time_major_layout(vd_aw.antenna1, vd_aw.antenna2,
                                          time_t, nT)
    if mr != 8 * nbl + nT // 128 + 64 or layout is not None:
        raise AssertionError(f"unexpected run bound {mr} or layout {layout}")

    stream.reset_launch_count()
    res = ds.aw_idg_image(vd_aw, ak, theta=THETA, lam=LAM, subgrid=SUBGRID,
                          taper_beta=BETA, device=dev)
    torch.cuda.synchronize()
    launches_aw = stream.launch_count(stream.GRID_KERNEL)
    img_aw = res.image.cpu().numpy()
    # the same pipeline on the plain gridder
    scr = ds._aw_screens(ak, SUBGRID, THETA, LAM, None, SINGLE, dev)
    uvw, f, vis = ds.idg_inputs(vd_aw, device=dev)
    a1d = torch.as_tensor(a1_t.astype(np.int32), device=dev)
    a2d = torch.as_tensor(a2_t.astype(np.int32), device=dev)
    ga, a1g, a2g = ds.aw_grid_inputs(uvw, a1d, a2d, f, vis, theta=THETA,
                                     lam=LAM, layout=layout)
    recs = idg_aw_run_records(ga.grid_shape, ga.p, a1g, a2g, ga.w,
                              ga.vis.real, ga.vis.imag, subgrid=SUBGRID,
                              support=SUPPORT, max_runs=mr, nant=nant)
    n_runs = int((recs[2] > recs[1]).sum())
    guv = stream.grid_from_records_plain(
        *recs[:7], scr, grid_shape=ga.grid_shape, theta=ga.theta,
        subgrid=SUBGRID, taper_beta=BETA)[SUBGRID:SUBGRID + n,
                                          SUBGRID:SUBGRID + n]
    img_plain = ds._idg_finish(guv, n, n, 0, SUBGRID, BETA).cpu().numpy()
    err_img = rel_l2(crop75(img_aw), crop75(img_plain))
    print(f"IDG-AW image: aw_idg_image {n}² from {nT} track records "
          f"({nant} stations, {nbl} baselines, {n_runs} runs of {mr}), "
          f"n_dropped {res.n_dropped}, gridder launches "
          f"{launches_aw}; vs plain-gridder pipeline rel-L2 {err_img:.3e} "
          f"over the central 75% (bound {IMAGE_TOL})")
    if not np.isfinite(img_aw).all():
        raise AssertionError("IDG-AW image has non-finite pixels")
    if res.n_dropped != 0 or int(recs[7]) != 0:
        raise AssertionError(f"IDG-AW imaging dropped {res.n_dropped}")
    if launches_aw < 1:
        raise AssertionError("IDG-AW imaging did not launch the gridder")
    if not err_img <= IMAGE_TOL:
        raise AssertionError(f"IDG-AW image parity failed: {err_img}")

    model_aw = np.zeros_like(img_aw)
    crop75(model_aw)[...] = crop75(img_aw)
    stream.reset_launch_count()
    pred_aw = ds.aw_predict_vis(vd_aw, ak, model_aw, theta=THETA, lam=LAM,
                                subgrid=SUBGRID, taper_beta=BETA, device=dev)
    torch.cuda.synchronize()
    launches_awp = stream.launch_count(stream.DEGRID_KERNEL)
    d = ds.degrid_inputs(torch.as_tensor(model_aw, device=dev), uvw, f,
                         theta=THETA, lam=LAM, subgrid=SUBGRID,
                         taper_beta=BETA)
    drecs = idg_aw_degrid_records(tuple(d.grid.shape), d.p, a1d, a2d, d.w,
                                  subgrid=SUBGRID, support=SUPPORT,
                                  max_runs=mr)
    plain_v = stream.degrid_from_records_plain(
        *drecs[:7], d.grid, scr, theta=d.theta, subgrid=SUBGRID,
        taper_beta=BETA).cpu().numpy()
    err_pred = rel_l2(pred_aw.vis.cpu().numpy(), plain_v)
    print(f"IDG-AW predict: aw_predict_vis from the image (central 75%) to "
          f"{nT} vis, peak |vis| {pred_aw.peak:.6g}, n_dropped "
          f"{pred_aw.n_dropped}, degrid launches {launches_awp}; vs plain "
          f"degridder rel-L2 {err_pred:.3e} (bound {KERNEL_TOL})")
    if not torch.isfinite(pred_aw.vis).all():
        raise AssertionError("IDG-AW prediction has non-finite values")
    if pred_aw.n_dropped != 0 or int(drecs[8]) != 0:
        raise AssertionError(f"IDG-AW predict dropped {pred_aw.n_dropped}")
    if launches_awp < 1:
        raise AssertionError("IDG-AW predict did not launch the degridder")
    if not err_pred <= KERNEL_TOL:
        raise AssertionError(f"IDG-AW predict parity failed: {err_pred}")

    # ---- 9b. band fold: the reference's banded 4800² shape -----------------
    theta_lg = 0.016
    n_lg = int(round(theta_lg * LAM))
    rng = np.random.default_rng(11)
    ntime_b = 520
    u0 = rng.uniform(-0.40, 0.40, (nbl, 2))
    du = rng.uniform(-30.0 / n_lg, 30.0 / n_lg, (nbl, 2))
    ft = (np.arange(ntime_b) / ntime_b)[:, None]
    p_b = np.zeros((nbl * ntime_b, 3), np.float32)
    p_b[:, 0] = (u0[None, :, 0] + du[None, :, 0] * ft).ravel()
    p_b[:, 1] = (u0[None, :, 1] + du[None, :, 1] * ft).ravel()
    n_b = p_b.shape[0]
    w_b = rng.uniform(-3800, 3800, n_b).astype(np.float32)
    a1_b = np.broadcast_to(ii[None, :], (ntime_b, nbl)).ravel()
    a2_b = np.broadcast_to(jj[None, :], (ntime_b, nbl)).ravel()
    vis_b = (rng.standard_normal(n_b) + 1j * rng.standard_normal(n_b))
    mr_b = 16 * nbl + n_b // 128 + 64
    t = [torch.as_tensor(x, device=dev) for x in (
        p_b, a1_b.astype(np.int32), a2_b.astype(np.int32), w_b)]
    vis_bt = torch.as_tensor(vis_b.astype(np.complex64), device=dev)
    unit = torch.ones((nant, SUBGRID, SUBGRID), dtype=torch.complex64,
                      device=dev)
    shape_b = (n_lg, n_lg)
    recs = idg_aw_run_records(shape_b, *t, vis_bt.real, vis_bt.imag,
                              subgrid=SUBGRID, support=SUPPORT,
                              max_runs=mr_b, nant=nant)
    kg = stream.idg_aw_grid_from_records_stream(
        *recs[:7], shape_b, unit, theta=theta_lg, subgrid=SUBGRID,
        taper_beta=BETA)
    pg = stream.grid_from_records_plain(
        *recs[:7], unit, grid_shape=shape_b, theta=theta_lg,
        subgrid=SUBGRID, taper_beta=BETA)[SUBGRID:SUBGRID + n_lg,
                                          SUBGRID:SUBGRID + n_lg]
    err_g = rel_l2(kg.cpu().numpy(), pg.cpu().numpy())
    drecs_b, kd, pd = degrid_both(shape_b, *t, kg, unit, theta_lg, mr_b)
    err_d = rel_l2(kd, pd)
    print(f"band fold ({n_lg}², S=64, {n_b} records, {nant} stations, "
          f"{ntime_b} times, max_runs {mr_b}): grid rel-L2 {err_g:.3e}, "
          f"degrid rel-L2 {err_d:.3e} (bound {KERNEL_TOL}), n_dropped grid "
          f"{int(recs[7])} degrid {int(drecs_b[8])}")
    if int(recs[7]) != 0 or int(drecs_b[8]) != 0:
        raise AssertionError("the 4800² shape dropped records")
    if not (err_g <= KERNEL_TOL and err_d <= KERNEL_TOL):
        raise AssertionError(f"4800² parity failed: {err_g}, {err_d}")

    # ---- 10. times --------------------------------------------------------
    kw = dict(theta=g.theta, subgrid=SUBGRID, taper_beta=BETA)
    unit = unit[:1]
    ms_kernel = timed_ms(
        torch, lambda: stream.idg_aw_degrid_from_records_stream(
            *drecs_full[:7], grid_full, unit, **kw))
    ms_plain = timed_ms(torch, lambda: stream.degrid_from_records_plain(
        *drecs_full[:7], grid_full, unit, **kw))
    ms_prep = timed_ms(torch, lambda: idg_aw_degrid_records(
        g.grid_shape, g.p, zer, zer, g.w, subgrid=SUBGRID, support=SUPPORT,
        max_runs=mr_unit))
    ms_pred = timed_ms(torch, lambda: ds.idg_predict_vis(
        vd, model, theta=THETA, lam=LAM, subgrid=SUBGRID, taper_beta=BETA,
        device=dev))
    ms_aw_img = timed_ms(torch, lambda: ds.aw_idg_image(
        vd_aw, ak, theta=THETA, lam=LAM, subgrid=SUBGRID, taper_beta=BETA,
        device=dev))
    ms_aw_pred = timed_ms(torch, lambda: ds.aw_predict_vis(
        vd_aw, ak, model_aw, theta=THETA, lam=LAM, subgrid=SUBGRID,
        taper_beta=BETA, device=dev))
    for label, ms, count in (
            ("degridder kernel (CUDA)", ms_kernel, n_vis),
            ("degridder plain (PyTorch)", ms_plain, n_vis),
            ("degrid prep (sort + CSR)", ms_prep, n_vis),
            ("idg_predict_vis end to end", ms_pred, n_vis),
            ("aw_idg_image end to end", ms_aw_img, nT),
            ("aw_predict_vis end to end", ms_aw_pred, nT)):
        print(f"time {label}: {ms:.3f} ms = {count / ms / 1e3:.2f} M vis/s "
              f"[{card}]")
    return {"launches": launches, "max_abs_err": max_abs, "ms": ms_kernel,
            "plain_ms": ms_plain}


if __name__ == "__main__":
    sys.exit(main())
