#!/usr/bin/env python3
"""Chip smoke test of ska_sdp_tpu_torch: the ported imaging, prediction and
spectral-cube paths end to end on one NVIDIA GPU, through the hand-written
CUDA kernels (the streamed IDG gridder and degridder, the bank w-projection
scatter and gather, the fused AW gridder, the fixed-tile IDG gridder and
degridder).

    python3 chip_smoke.py

Phases (each failure raises; the script then exits non-zero and prints no
result line):

1. device: a CUDA card is required (no CPU fallback); versions and the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build: compile ``ska_sdp_tpu_torch/csrc/idg_grid.cu``,
   ``csrc/idg_degrid.cu``, ``csrc/wproj_grid.cu``, ``csrc/wproj_degrid.cu``,
   ``csrc/aw_grid.cu``, ``csrc/idg_tile_grid.cu`` and
   ``csrc/idg_tile_degrid.cu`` with nvcc for sm_90a, one nvcc each, all
   started together; print the gridder's build time and ptxas resource use;
3. gridder parity on the card against the plain PyTorch version on the
   same inputs: a mid-size IDG-AW case (512² grid, S=64, 16 antennas of
   track data, random screens), the same records at S=32 (support 7) and
   S=128, a hand-made table with one run of 25,000 records among 500 short
   ones, empty and sentinel entries, and the full-size unit-screen records
   of the main path; grid rel-L2 ≤ 5e-5 and equal ``n_dropped``;
4. IDG imaging main path: a synthetic SKA1-Low observation (512 stations,
   8 times, seed 1234: 1,046,528 visibilities) imaged by ``idg_image`` on a
   2400² grid (θ=0.008, lam=300000, S=64, support 15, β=12) with the launch
   counts reset just before; checks a finite image, no drops, at least one
   gridder launch, the peak at a simulated source, every source's 5×5
   window above 0.25·max, and image rel-L2 ≤ 1e-4 over the central 75%
   against the same pipeline with the plain gridder on the card;
5. gridder times (CUDA events, median of 7 after a warm-up): the kernel,
   its plain version, the run prep, and ``idg_image`` end to end; the run
   table's longest and mean run, and the gridder's two bounds (f32 on the
   CUDA cores, and the tensor-core bound of its split-fp16 products);
6. build: the degridder's build time and ptxas resource use;
7. degridder parity on the card against its plain version: the mid-size
   IDG-AW case of phase 3 degridding a random grid at S=64, 32 (support
   7) and 128, phase 3c's table (one run of 25,000 records among 500 short
   ones, empty and sentinel entries) degridding the same grid, the
   sentinel runs' records predicting exactly 0, and the full-size
   unit-screen records degridding phase 3's grid; predicted-visibility
   rel-L2 ≤ 5e-5 and equal ``n_dropped``; and the adjoint identity
   through both streamed kernels on the mid-size case to 1e-5;
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
    kernel at the main path and at phase 9's IDG-AW track shape (each
    beside the f32 design's time that ``PERF.md`` records), its plain
    version, the degrid prep, and IDG predict, IDG-AW image and IDG-AW
    predict end to end; the degridder's two bounds, as the gridder's;
11. build: the w-projection kernels' build times and ptxas resource use;
12. w-projection kernel parity on the card against the plain versions
    (``ops/gridding.py``) on the same inputs: grid and visibility rel-L2
    ≤ 5e-5 (float32 sums in atomic order) and equal counts of valid
    records, at a mid-size 512² shape (nw=4, qpx=4, random bank, records
    beyond the grid's edges), at the reference benchmark's full-size shape
    (2400², ``bench.py``'s 1,048,576 uniform records and NW=32, QPX=8, 15²
    random bank from numpy seed 0), at its 4800² shape (θ=0.016, the
    same records and bank: the fold of the tiled TPU kernels), and skewed:
    262,144 records of that bank all inside one 32² output tile of the
    scatter and one 32² tile of the gather (one tile's entries spread
    over many warps of the scatter and many blocks of the gather);
13. w-projection main paths on phase 4's observation with a 32-plane,
    qpx=8, 15² bank (npix_ff=256) for its w range, built on the card by
    ``ops/wkernel``, each with the launch counts reset just before:
    ``w_image`` (finite, at least one scatter launch, the peak at a
    source, every source's 5×5 window above 0.25·max, rel-L2 ≤ 1e-4
    against the same pipeline on the plain scatter) and ``w_predict_vis``
    of phase 8's model (at least one gather launch, rel-L2 ≤ 5e-5 against
    the plain gather); the adjoint identity through both kernels to 1e-5;
    printed without a bound: the image against phase 4's IDG image, and
    the prediction, and one through the conjugated bank, against phase 8's
    float64 direct DFT;
14. w-projection times (CUDA events, median of 7 after a warm-up): each
    kernel and its plain version at the full-size shape (the gather beside
    its earlier design's time that ``PERF.md`` records), each kernel on
    the main path's records, the bank build, and ``w_image`` and
    ``w_predict_vis`` end to end;
15. build: the fused AW gridder's build time and ptxas resource use;
16. fused AW kernel parity on the card against ``aw_fused_plain`` on the
    same records and tables: grid rel-L2 ≤ 5e-5 (float32 sums in atomic
    order) and the kernel's count of placed records equal to the count of
    valid records, at (a) 512², 16 antennas, nw=4, qpx=4, random bank and
    A-kernels, records beyond the edges, s=15, s=7 and s=32 (m = 64), and
    s=15 with half the records on one pair (its run cut into many work
    items); (b) the reference
    benchmark's fused-AW shape (2400², NW=32, QPX=8, 15², 64 antennas,
    ``bench_records``' first 524,288 records, random A-kernels and
    antennas from seed 1); (c) the same records and tables at 4800²
    (θ=0.016: the fold of the tiled TPU kernel); (d) the main path's 512
    stations (the fold of the slab route);
17. fused AW main path: ``aw_image`` of phase 4's observation with phase
    13's bank and near-delta A-kernels for its 512 stations
    (``io.synthetic.akern_stamps``), with the launch counts reset just
    before; checks a finite image, at least one launch, the peak at a
    source, every source's 5×5 window above 0.25·max, and image rel-L2 ≤
    1e-4 over the central 75% against the same pipeline on
    ``aw_fused_plain``; printed without a bound, its rel-L2 against phase
    13's ``w_image``;
18. fused AW times (CUDA events, median of 7 after a warm-up): the kernel
    and ``aw_fused_plain`` at shapes (b) and (d), the tables (pair remap,
    pair table, w-tap spectra) at 64 and 512 stations, and ``aw_image`` end
    to end;
19. build: the fixed-tile IDG kernels' build times and ptxas resource use;
20. fixed-tile parity on the card, each kernel against its plain version
    on the same records: 512² (θ=0.008) at S=16 (support 7), 32, 48 and
    128 (support 15), 200,000 random records with |p| ≤ 0.53 and |w| ≤
    100,000 λ and a random grid, and the main path's 1,046,528 records at
    S=32 (phase 4's weighted mirrored visibilities; phase 8's model grid);
    grid and visibility rel-L2 ≤ 5e-5, off-grid records predicting 0;
21. the S=32 main paths on phase 4's observation, each with the launch
    counts reset just before: ``idg_image(subgrid=32)`` (at least one
    fixed-tile launch and no streamed one, phase 4's image checks, rel-L2
    ≤ 1e-4 over the central 75% against the pipeline on the plain
    fixed-tile gridder; printed without a bound, against phase 4's S=64
    image), ``idg_predict_vis(subgrid=32)`` of phase 8's model (rel-L2 ≤
    5e-5 against the plain fixed-tile degridder; printed beside the
    reference's S=32 bound of 3e-4, against phase 8's direct DFT), and the
    stage-timed ``_idg_staged`` at S=64 in memory (image within 1e-4 of
    phase 4's over the central 75%, at least one fixed-tile launch, the
    four stage times);
22. fixed-tile times (CUDA events, median of 7 after a warm-up) at S=32
    on the main path: each kernel and its plain version, the preps, the
    degrid prologue, and ``idg_image`` and ``idg_predict_vis`` end to end;
23. spectral kernel parity on the card (the fold evidence for the
    run-major #5): phase 3a's 512² IDG-AW records with random screens and
    4 channels of random visibilities at r ∈ {0.97, 0.99, 1.01, 1.03},
    through the multi prep and each channel's update, every channel's
    records through ``idg_grid.cu`` and its plain version (drift 7: nothing
    masked; drift 0: records masked and counted), and the fixed-tile multi
    prep at S=32 through ``idg_tile_grid.cu``; grid rel-L2 ≤ 5e-5;
24. the cube main paths at full width on bench cell 8's observation (64
    stations, 520 times, 8 channels, seed 6: 1,048,320 records, 8,386,560
    channel-visibilities, 2400²), each with the launch counts reset just
    before: ``idg_cube`` at S=64 (one group, the streamed branch) and at
    S=32 (the fixed-tile branch), ``w_cube`` with phase 13's kind of bank,
    and ``aw_idg_cube`` at S=64 on the benchmark's 64-station track records
    as a real [520, 2016] raster of 8 channels (the ordered prep); each
    launches its kernel once per channel, is finite, drops nothing (S=32
    counts the drops of the reference's centred window, which has no slack
    below at S=32) and is within 1e-4 (IDG: central 75%) of the same entry
    on the plain kernels on the card; the continuum peak at a source; with
    ``SKA_SDP_TPU_EXACT_WEIGHTS=1`` channels 0 and 7 of the S=64 IDG cube
    within 1e-4 (central 75%) of ``idg_image`` of that channel alone, both
    in double precision (the weights; the kernels run in float32); and,
    printed without a bound, the drops of ``aw_idg_cube`` on cell 8's
    Earth-rotation tracks, whose runs outgrow the reference's run bound;
25. cube times (CUDA events, median of 7 after a warm-up): each cube end to
    end in channel-visibilities per second, the multi preps, and one
    channel's kernel, with the kernel's bound for the 8 channels (the
    streamed gridder's tensor-core bound beside it).

The line before last is the ``nvidia-smi`` name and power limit, the one
before it a JSON summary of the kernels (``replaces`` lists each TPU
kernel the CUDA kernel stands for, folds included; ``bound_ms`` is the
larger of the f32 operations over 67 TFLOP/s and the bytes over 3.35 TB/s,
from this run's inputs, and for ``idg_grid_stream`` and
``idg_degrid_stream``, whose products run on the tensor cores, the larger
of those products over 989 TFLOP/s, their f32 phase work over 67 TFLOP/s
and the bytes, each run's sandwich placed on whichever unit finishes
soonest); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
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
ADJOINT_TOL = 1e-5       # <G, grid(v)> against <degrid(G), v>, float32
F32_FLOPS = 67e12        # H100 SXM peak, float32 outside the tensor cores
BF16_FLOPS = 989e12      # H100 SXM dense bf16 / fp16 tensor-core peak
HBM_BPS = 3.35e12        # H100 SXM device-memory rate
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


def bound(ops: float, nbytes: float):
    """``(bound_ms, bound_by)``: the larger of the operations over the f32
    peak and the bytes over the memory rate."""
    t_ops = ops / F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def sandwich_flop(S: int):
    """``(least, dense, fft)`` f32 operations of one S×S subgrid sandwich
    F′·a·F′ᵀ, F′ a centred S-point DFT with the taper folded in: dense it
    is two complex S³ products, 16·S³; as a taper multiply and a 2-D
    radix-2 FFT (2S transforms of 5·S·log2(S)) it is
    10·S²·log2(S) + 6·S².  A bound counts the least."""
    dense = 16 * S ** 3
    fft = 10 * S * S * math.log2(S) + 6 * S * S
    return min(dense, fft), dense, fft


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


# ---- the main paths' inputs (shared with scripts/profile_torch.py) --------
def main_observation():
    """Phase 4's synthetic SKA1-Low observation: ``(obs dict, VisData)``."""
    from ska_sdp_tpu_torch.io.synthetic import (SyntheticConfig,
                                                simulate_observation)
    from ska_sdp_tpu_torch.models.dataset import vis_data_from_observation

    obs = simulate_observation(SyntheticConfig(theta=THETA, lam=LAM,
                                               nant=512, ntime=8, seed=1234))
    return obs, vis_data_from_observation(obs)


def snapped_model(obs, n: int):
    """Phase 8's ``[n, n]`` float32 model of the observation's sources,
    each snapped to a pixel centre inside the central 75%, and the snapped
    ``(l, m, flux)`` list."""
    model = np.zeros((n, n), np.float32)
    srcs = []
    for l, m, flux in obs["sources"]:
        py, px = int(round(n / 2 + m * LAM)), int(round(n / 2 + l * LAM))
        if not (n // 8 <= min(py, px) and max(py, px) < n - n // 8):
            raise AssertionError("a source lies outside the central 75%")
        model[py, px] += flux
        srcs.append(((px - n // 2) / LAM, (py - n // 2) / LAM, flux))
    return model, srcs


def aw_track_inputs():
    """Phase 9's IDG-AW inputs: the reference benchmark's 64-station track
    records (seed 11), pair-major, as a ``VisData`` at frequency c with
    random complex 15×15 A-kernels (seed 12).  Returns a namespace."""
    from types import SimpleNamespace

    from ska_sdp_tpu_torch.models.dataset import VisData

    nant = 64
    ii, jj = np.triu_indices(nant, k=1)
    nbl = ii.shape[0]
    n = int(round(THETA * LAM))
    p_t, tshape = track_records(nbl, 65, 8, n, np.random.default_rng(11))
    nT = p_t.shape[0]
    # pair-major, channels then time inner: each (baseline, channel) track
    # is one segment.  (As a time-major raster of 16,128 "baselines" the
    # 8 channel tracks of a pair would enter the unsorted prep as 8
    # segments each and overflow the 8·npair run bound.)
    pm = np.arange(nT).reshape(tshape).transpose(1, 2, 0).ravel()
    p_t = p_t[pm]
    a1 = np.broadcast_to(ii[None, :, None], tshape).ravel()[pm]
    a2 = np.broadcast_to(jj[None, :, None], tshape).ravel()[pm]
    time_t = np.broadcast_to(np.arange(65.0)[:, None, None], tshape
                             ).ravel()[pm]
    rng = np.random.default_rng(12)
    ak = (rng.standard_normal((nant, 15, 15))
          + 1j * rng.standard_normal((nant, 15, 15)))
    uvw_t = np.stack([p_t[:, 0] * LAM, p_t[:, 1] * LAM, p_t[:, 2]], 1)
    vis_t = (rng.standard_normal(nT) + 1j * rng.standard_normal(nT))
    vd = VisData(vis_t, uvw_t.astype(np.float64), a1.astype(np.int64),
                 a2.astype(np.int64), time_t, C)
    return SimpleNamespace(vd=vd, ak=ak, a1=a1, a2=a2, time=time_t,
                           nant=nant, ii=ii, jj=jj, nbl=nbl, n=nT)


def w_bank_inputs(torch, obs, dev):
    """Phase 13's w-kernel bank for the observation's w range: the 32 plane
    centres (numpy) and a function that builds the qpx=8, 15², npix_ff=256
    bank on the card."""
    from ska_sdp_tpu_torch.config import KernelOptions
    from ska_sdp_tpu_torch.io.synthetic import SyntheticConfig, w_plane_centers
    from ska_sdp_tpu_torch.ops.wkernel import w_kernel

    centers = w_plane_centers(obs, SyntheticConfig(theta=THETA, lam=LAM,
                                                   nw_planes=32))
    opts = KernelOptions(qpx=8, npix_ff=256, npix_kern=15)
    centers_t = torch.as_tensor(centers, device=dev)
    return centers, lambda: w_kernel(THETA, centers_t, opts, device=dev)


def main_akerns():
    """Phase 17's near-delta 15² A-kernels of the observation's 512
    stations, ``[512, 15, 15]`` complex128, as ``--make-data`` writes them
    at the first time and frequency."""
    from ska_sdp_tpu_torch.io.synthetic import SyntheticConfig, akern_stamps

    return akern_stamps(SyntheticConfig(theta=THETA, lam=LAM, nant=512,
                                        seed=1234))[:, 0, 0]


def cube_observation():
    """Phase 24's observation, bench cell 8's (``bench.py:630-641``): the
    synthetic generator's 64 stations, 520 times, 8 channels 100 kHz apart
    from 150 MHz, 3 sources, seed 6, as ``(obs dict, VisData)``."""
    from ska_sdp_tpu_torch.io.synthetic import (SyntheticConfig,
                                                simulate_observation)
    from ska_sdp_tpu_torch.models.dataset import vis_data_from_observation

    obs = simulate_observation(SyntheticConfig(
        theta=THETA, lam=LAM, nant=64, ntime=520, nchan=8, nsources=3,
        seed=6))
    return obs, vis_data_from_observation(obs)


def cube_akerns():
    """The near-delta 15² A-kernels ``--make-data`` writes for phase 24's 64
    stations (seed 6) at the first time and frequency."""
    from ska_sdp_tpu_torch.io.synthetic import SyntheticConfig, akern_stamps

    return akern_stamps(SyntheticConfig(theta=THETA, lam=LAM, nant=64,
                                        seed=6))[:, 0, 0]


def aw_cube_inputs():
    """Phase 24's IDG-AW cube input: the reference benchmark's 64-station
    track records (seed 11, 2016 baselines) over 520 times as a real
    time-major [520, 2016] raster with 8 channels 100 kHz apart from 150 MHz
    (uv = p·lam at the band centre) and random visibilities (seed 12):
    1,048,320 records, 8,386,560 channel-visibilities."""
    from ska_sdp_tpu_torch.models.dataset import VisData

    nant, ntime, nchan = 64, 520, 8
    ii, jj = np.triu_indices(nant, k=1)
    nbl = ii.shape[0]
    p, _ = track_records(nbl, ntime, 1, int(round(THETA * LAM)),
                         np.random.default_rng(11))
    n = p.shape[0]
    freqs = 1.5e8 + 1.0e5 * np.arange(nchan)
    uvw = np.stack([p[:, 0] * LAM, p[:, 1] * LAM, p[:, 2]], 1).astype(
        np.float64) * (C / (0.5 * (freqs[0] + freqs[-1])))
    rng = np.random.default_rng(12)
    vis = rng.standard_normal((n, nchan)) + 1j * rng.standard_normal(
        (n, nchan))
    return VisData(vis[:, 0], uvw,
                   np.broadcast_to(ii[None, :], (ntime, nbl)).ravel().copy(),
                   np.broadcast_to(jj[None, :], (ntime, nbl)).ravel().copy(),
                   np.repeat(np.arange(ntime, dtype=np.float64), nbl),
                   float(freqs[0]), vis, freqs)


def cube_group_inputs(torch, dev, vd, group):
    """A cube channel group's weighted, mirrored inputs as the spectral
    drivers form them: ``(uvw1, vis1 [nch, n], r0, drift)``, ``r0`` the
    first channel's frequency over the group's reference."""
    from ska_sdp_tpu_torch.models import spectral as sp

    i, j, f_ref, drift = group
    uvw = torch.as_tensor(np.asarray(vd.uvw, np.float32), device=dev)
    vis = torch.as_tensor(np.ascontiguousarray(
        vd.vis_chan[:, i:j], np.complex64), device=dev).T.contiguous()
    rat = torch.as_tensor((vd.frequencies[i:j] / f_ref).astype(np.float32),
                          device=dev)
    uvw1, vis1 = sp._group_inputs(uvw, f_ref, rat, vis, theta=THETA,
                                  lam=LAM, exact=False)
    return uvw1, vis1, float(rat[0]), drift


def cube_channel_prep(torch, dev, vd, group, ak=None):
    """Phase 25's multi prep of a cube's channel group at S=64: the IDG
    prep with unit screens, or with A-kernels ``ak`` the IDG-AW cube
    raster's ordered prep, pair-major.  Returns ``(prep, r0, screens)``;
    ``prep()`` runs ``idg_aw_run_records_multi``."""
    from ska_sdp_tpu_torch.kernels import idg_aw_records as awr
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.models import spectral as sp
    from ska_sdp_tpu_torch.types import SINGLE

    S = SUBGRID
    n = int(round(THETA * LAM))
    n_c = vd.uvw.shape[0]
    uvw1, vis1, r0, drift = cube_group_inputs(torch, dev, vd, group)
    if ak is not None:
        layout = ds._detect_time_major_layout(vd.antenna1, vd.antenna2,
                                              vd.time, n_c)
        a1, a2 = (sp._pair_major(torch.as_tensor(a.astype(np.int32),
                                                 device=dev), layout)
                  for a in (vd.antenna1, vd.antenna2))
        uvw1 = sp._pair_major(uvw1, layout)
        vis1 = sp._pair_major(vis1, layout, axis=1)
        scr = ds._aw_screens(ak, S, THETA, LAM, None, SINGLE, dev)
        mr = 8 * int(np.unique(vd.antenna1 * 64 + vd.antenna2).size) \
            + n_c // 128 + 64
    else:
        a1 = a2 = torch.zeros((n_c,), dtype=torch.int32, device=dev)
        scr = torch.ones((1, S, S), dtype=torch.complex64, device=dev)
        tc = max(2 * (S // 2 - SUPPORT // 2 - 12 - drift) - 2, 8)
        mr = ((n + 2 * S) // tc + 2) ** 2 + 64

    def prep():
        return awr.idg_aw_run_records_multi(
            (n, n), uvw1 / LAM, a1, a2, uvw1[:, 2], vis1.real, vis1.imag,
            subgrid=S, support=SUPPORT, max_runs=mr, drift_cells=drift,
            ordered=ak is not None)

    return prep, r0, scr


def long_run_table(torch, dev, shape, nant: int, seed: int):
    """Phase 3c's run table at S=64 on ``shape``: one run of 25,000 random
    records among 500 of 1–39, a fifth of the entries empty, a tenth with
    the prep's sentinel pair id (clamped by the kernel), 200 trailing empty
    entries; random origins and pair ids.  Returns the gridder's first
    seven arguments on ``dev``."""
    from ska_sdp_tpu_torch.ops.idg_aw import PAIR_SHIFT, SENTINEL

    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 40, 501)
    lengths[rng.random(501) < 0.2] = 0
    lengths[0] = 25000
    rng.shuffle(lengths)
    lengths = np.concatenate([lengths, np.zeros(200, np.int64)])
    n, R, d = int(lengths.sum()), lengths.shape[0], SUBGRID / 2 - 8
    recs = np.stack([rng.uniform(-d, d, n), rng.uniform(-d, d, n),
                     rng.uniform(-3800.0, 3800.0, n), rng.standard_normal(n),
                     rng.standard_normal(n)]).astype(np.float32)
    ext = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    ia = rng.integers(0, nant, (2, R)).astype(np.int32)
    sent = rng.random(R) < 0.1
    ia[0, sent], ia[1, sent] = SENTINEL // PAIR_SHIFT, SENTINEL % PAIR_SHIFT
    y0 = rng.integers(0, shape[0] + SUBGRID, R).astype(np.int32)
    x0 = rng.integers(0, shape[1] + SUBGRID, R).astype(np.int32)
    return [torch.as_tensor(np.ascontiguousarray(a), device=dev)
            for a in (recs, ext[:-1], ext[1:], y0, x0, ia[0], ia[1])]


def run_stats(starts, ends):
    """``(occupied runs, longest, mean)`` record counts of a run table."""
    n = (ends - starts)
    occ = n[n > 0]
    return int(occ.numel()), int(occ.max()), float(occ.float().mean())


def idg_stream_bounds(S: int, n_rec: int, n_runs: int, io: float):
    """The streamed gridder's (and, its adjoint, the streamed
    degridder's) bounds for ``n_rec`` records in ``n_runs`` runs:
    ``(f32, tensor_core)``.  ``f32`` is ``bound``'s ``(ms, by)`` of
    the function on the CUDA cores: 8·S² per record, per run the FFT
    sandwich and 12·S² of screens.  ``tensor_core`` is ``(ms, by, ms_tc,
    ms_cuda)`` with the gridder's accumulation, or the degridder's
    contraction, as ``csrc/idg_grid.cu`` and ``csrc/idg_degrid.cu``
    compute it, split3 on the tensor cores at the dense fp16/bf16 peak
    (3 × 8·S² per record), beside the f32 work on the CUDA cores (per
    record and subgrid index two ``sincosf`` counted at 20 flop and 20 flop
    of phases, u = v·e_y or the conj(e_y) weighting, and splits; 12·S² per
    run of screens).  Each run's sandwich
    goes where the two units finish soonest: dense split3 on the tensor
    cores (3 × 16·S³) or as the FFT count on the CUDA cores, the runs
    divided between them to balance the two times.  The bound is the
    larger of those times and the bytes."""
    least, _, fft = sandwich_flop(S)
    f32 = bound(8 * S * S * n_rec + (least + 12 * S * S) * n_runs, io)
    a = 3 * 8 * S * S * n_rec / BF16_FLOPS * 1e3        # tensor cores
    b = (60 * S * n_rec + 12 * S * S * n_runs) / F32_FLOPS * 1e3
    d = 3 * 16 * S ** 3 * n_runs / BF16_FLOPS * 1e3     # all dense on TC
    c = fft * n_runs / F32_FLOPS * 1e3                   # all FFT on CUDA
    f = min(1.0, max(0.0, (b + c - a) / (c + d)))       # share sent to TC
    t_tc, t_cuda = a + f * d, b + (1 - f) * c
    t_bytes = io / HBM_BPS * 1e3
    ms = max(t_tc, t_cuda, t_bytes)
    return f32, (ms, "operations" if ms > t_bytes else "bytes", t_tc,
                 t_cuda)


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

    kernels_cu = ("idg_grid", "idg_degrid", "wproj_grid", "wproj_degrid",
                  "aw_grid", "idg_tile_grid", "idg_tile_degrid")
    pool = ThreadPoolExecutor(max_workers=len(kernels_cu))
    builds = {k: pool.submit(build, k) for k in kernels_cu}
    pool.shutdown(wait=False)
    print(f"build: idg_grid.cu for sm_90a in "
          f"{builds['idg_grid'].result():.1f} s")
    print_ptxas(_build.build_log, "idg_grid")

    def rr(shape, p, a1, a2, w, vis, max_runs, nant):
        return idg_aw_run_records(shape, p, a1, a2, w, vis.real, vis.imag,
                                  subgrid=SUBGRID, support=SUPPORT,
                                  max_runs=max_runs, nant=nant)

    def both(recs, shape, scr, theta, S=SUBGRID):
        k = stream.idg_aw_grid_from_records_stream(
            *recs[:7], shape, scr, theta=theta, subgrid=S, taper_beta=BETA)
        pl = stream.grid_from_records_plain(
            *recs[:7], scr, grid_shape=shape, theta=theta, subgrid=S,
            taper_beta=BETA)[S:S + shape[0], S:S + shape[1]]
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
               scr=scr, ak=ak, n=vis.shape[0])

    # ---- 3c. the other subgrids, and a long run beside short ones --------
    for S_c, sup in ((32, 7), (128, SUPPORT)):
        scr_c = torch.as_tensor(aw_screens_host(ak, S_c).astype(
            np.complex64), device=dev)
        recs_c = idg_aw_run_records(
            shape, mid["p"], a1, a2, mid["w"], vis1.real, vis1.imag,
            subgrid=S_c, support=sup, max_runs=65536, nant=16)
        k, pl = both(recs_c, shape, scr_c, THETA, S_c)
        err = rel_l2(k.cpu().numpy(), pl.cpu().numpy())
        n_occ, longest, mean = run_stats(recs_c[1], recs_c[2])
        print(f"parity mid at S={S_c} (support {sup}, random screens, "
              f"{n_occ} runs, longest {longest}): rel-L2 {err:.3e} (bound "
              f"{KERNEL_TOL}), n_dropped {int(recs_c[7])} both ways")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"S={S_c} kernel parity failed: {err}")
    long_recs = long_run_table(torch, dev, shape, nant=16, seed=3)
    k, pl = both(long_recs, shape, scr, THETA)
    err = rel_l2(k.cpu().numpy(), pl.cpu().numpy())
    n_occ, longest, mean = run_stats(long_recs[1], long_recs[2])
    print(f"parity long run (S=64, {n_occ} runs, longest {longest}, mean "
          f"{mean:.1f}, empty and sentinel entries, random screens): rel-L2 "
          f"{err:.3e} (bound {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"long-run kernel parity failed: {err}")

    # ---- 3b. full-size unit-screen parity (the main path's records) ------
    obs, vd = main_observation()
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
    S = SUBGRID
    n_occ, longest, mean = run_stats(recs[1], recs[2])
    # per run the pair screen (A1·A2, then its product with a: 12·S²) and
    # the sandwich; inputs read once (records, run tables, screens), the
    # padded grid written once
    io = nbytes(*recs[:7], unit) + (n + 2 * S) ** 2 * 8
    (f32_ms, f32_by), (bound_ms, bound_by, t_tc, t_cuda) = idg_stream_bounds(
        S, n_vis, n_occ, io)
    per_run = [c + 12 * S * S for c in sandwich_flop(S)]
    print(f"  runs: {n_occ} occupied of {recs[1].shape[0]}, longest "
          f"{longest} records, mean {mean:.1f}")
    print(f"idg gridder bounds at S={S}: f32 {f32_ms:.3f} ms ({f32_by}; "
          f"{n_occ} runs x {per_run[0]:.0f} flop, FFT sandwich, + 8·S² x "
          f"{n_vis} records; dense sandwich "
          f"{bound(8 * S * S * n_vis + per_run[1] * n_occ, io)[0]:.3f} ms); "
          f"tensor core {bound_ms:.3f} ms ({bound_by}: split3 products "
          f"{t_tc:.3f} ms at 989 TFLOP/s, phase factors and screens "
          f"{t_cuda:.3f} ms at 67 TFLOP/s, bytes "
          f"{io / HBM_BPS * 1e3:.3f} ms)")

    # ---- 6.-10. the degridder and the predict and IDG-AW paths ------------
    print(f"build: idg_degrid.cu for sm_90a in "
          f"{builds['idg_degrid'].result():.1f} s (started with idg_grid.cu)")
    print_ptxas(_build.build_log, "idg_degrid")
    degrid, model, truth = degrid_phases(torch, dev, card, mid, vd, obs,
                                         k_full)
    for k in ("wproj_grid", "wproj_degrid"):
        print(f"build: {k}.cu for sm_90a in {builds[k].result():.1f} s "
              "(started with idg_grid.cu)")
        print_ptxas(_build.build_log, k)
    wproj, img_w = wproj_phases(torch, dev, card, vd, obs, img, model,
                                truth)
    print(f"build: aw_grid.cu for sm_90a in "
          f"{builds['aw_grid'].result():.1f} s (started with idg_grid.cu)")
    print_ptxas(_build.build_log, "aw_grid")
    aw = aw_phases(torch, dev, card, vd, obs, img_w)
    for k in ("idg_tile_grid", "idg_tile_degrid"):
        print(f"build: {k}.cu for sm_90a in {builds[k].result():.1f} s "
              "(started with idg_grid.cu)")
        print_ptxas(_build.build_log, k)
    tile = tile_phases(torch, dev, card, vd, obs, img, model, truth)
    spectral_phases(torch, dev, card, mid)

    print(json.dumps({"kernels": [{
        "name": stream.GRID_KERNEL,
        "route": "cuda",
        "source": "ska_sdp_tpu_torch/csrc/idg_grid.cu",
        "replaces": "ska_sdp_tpu/kernels/idg_aw_stream_pallas.py:161, "
                    "ska_sdp_tpu/kernels/idg_aw_stream_pallas.py:873, "
                    "ska_sdp_tpu/kernels/idg_aw_pallas.py:360",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": stream.DEGRID_KERNEL,
        "route": "cuda",
        "source": "ska_sdp_tpu_torch/csrc/idg_degrid.cu",
        "replaces": "ska_sdp_tpu/kernels/idg_aw_stream_pallas.py:475, "
                    "ska_sdp_tpu/kernels/idg_aw_stream_pallas.py:1014, "
                    "ska_sdp_tpu/kernels/idg_aw_degrid_pallas.py:82",
        **degrid,
    }, *wproj, aw, *tile]}))
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
    from ska_sdp_tpu_torch.ops.idg_aw import PAIR_SHIFT, aw_screens_host
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

    # ---- 7e. the adjoint identity through both streamed kernels -----------
    vis_r = torch.as_tensor((rng.standard_normal(mid["n"])
                             + 1j * rng.standard_normal(mid["n"])).astype(
        np.complex64), device=dev)
    kw_a = dict(theta=THETA, subgrid=SUBGRID, support=SUPPORT,
                taper_beta=BETA, max_runs=65536)
    g_a, _ = stream.idg_aw_gridder_stream(shape, mid["p"], mid["a1"],
                                          mid["a2"], mid["w"], vis_r,
                                          mid["scr"], **kw_a)
    d_a, _ = stream.idg_aw_degridder_stream(shape, mid["p"], mid["a1"],
                                            mid["a2"], mid["w"], grid_mid,
                                            mid["scr"], **kw_a)
    lhs = torch.vdot(grid_mid.reshape(-1).to(torch.complex128),
                     g_a.reshape(-1).to(torch.complex128)).item()
    rhs = torch.vdot(d_a.to(torch.complex128),
                     vis_r.to(torch.complex128)).item()
    err_adj = abs(lhs - rhs) / abs(lhs)
    print(f"IDG adjoint on the card (phase 3a's records, random screens): "
          f"|<G, grid(v)> - <degrid(G), v>| / |<G, grid(v)>| = "
          f"{err_adj:.3e} (bound {ADJOINT_TOL})")
    if not err_adj <= ADJOINT_TOL:
        raise AssertionError(f"IDG adjoint identity failed: {err_adj}")

    # ---- 7c. a long run beside short ones (phase 3c's table) --------------
    lr = long_run_table(torch, dev, shape, nant=16, seed=3)
    n_lr = lr[0].shape[1]
    perm = torch.as_tensor(np.random.default_rng(9).permutation(n_lr)
                           .astype(np.int32), device=dev)
    lr_d = (lr[0][:3].contiguous(), torch.cat([lr[1], lr[2][-1:]]), *lr[3:],
            perm)
    kw_lr = dict(theta=THETA, subgrid=SUBGRID, taper_beta=BETA)
    k = stream.idg_aw_degrid_from_records_stream(*lr_d, grid_mid,
                                                 mid["scr"], **kw_lr)
    pl = stream.degrid_from_records_plain(*lr_d, grid_mid, mid["scr"],
                                          **kw_lr)
    k, pl = k.cpu().numpy(), pl.cpu().numpy()
    err = rel_l2(k, pl)
    n_occ, longest, mean = run_stats(lr[1], lr[2])
    n_zero = int((pl == 0).sum())
    print(f"degrid parity long run (S=64, {n_occ} runs, longest {longest}, "
          f"mean {mean:.1f}, empty and sentinel entries, random screens, "
          f"random grid): rel-L2 {err:.3e} (bound {KERNEL_TOL}); records "
          f"predicting 0 (sentinel runs) kernel {int((k == 0).sum())} plain "
          f"{n_zero}")
    if not err <= KERNEL_TOL or not np.array_equal(k == 0, pl == 0):
        raise AssertionError(f"long-run degrid parity failed: {err}")

    # ---- 7d. the other subgrids ---------------------------------------------
    for S_c, sup in ((32, 7), (128, SUPPORT)):
        scr_c = torch.as_tensor(aw_screens_host(mid["ak"], S_c).astype(
            np.complex64), device=dev)
        recs_c = idg_aw_degrid_records(shape, mid["p"], mid["a1"],
                                       mid["a2"], mid["w"], subgrid=S_c,
                                       support=sup, max_runs=65536)
        kw_c = dict(theta=THETA, subgrid=S_c, taper_beta=BETA)
        k = stream.idg_aw_degrid_from_records_stream(*recs_c[:7], grid_mid,
                                                     scr_c, **kw_c)
        pl = stream.degrid_from_records_plain(*recs_c[:7], grid_mid, scr_c,
                                              **kw_c)
        err = rel_l2(k.cpu().numpy(), pl.cpu().numpy())
        print(f"degrid parity mid at S={S_c} (support {sup}, random "
              f"screens, random grid): rel-L2 {err:.3e} (bound "
              f"{KERNEL_TOL}), n_dropped {int(recs_c[8])} both ways")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"S={S_c} degrid parity failed: {err}")

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
    model, srcs = snapped_model(obs, n)
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
    t_aw = aw_track_inputs()
    vd_aw, ak, a1_t, a2_t, time_t = (t_aw.vd, t_aw.ak, t_aw.a1, t_aw.a2,
                                     t_aw.time)
    nant, ii, jj, nbl, nT = t_aw.nant, t_aw.ii, t_aw.jj, t_aw.nbl, t_aw.n
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
    ms_track = timed_ms(
        torch, lambda: stream.idg_aw_degrid_from_records_stream(
            *drecs[:7], d.grid, scr, theta=d.theta, subgrid=SUBGRID,
            taper_beta=BETA))
    ms_pred = timed_ms(torch, lambda: ds.idg_predict_vis(
        vd, model, theta=THETA, lam=LAM, subgrid=SUBGRID, taper_beta=BETA,
        device=dev))
    ms_aw_img = timed_ms(torch, lambda: ds.aw_idg_image(
        vd_aw, ak, theta=THETA, lam=LAM, subgrid=SUBGRID, taper_beta=BETA,
        device=dev))
    ms_aw_pred = timed_ms(torch, lambda: ds.aw_predict_vis(
        vd_aw, ak, model_aw, theta=THETA, lam=LAM, subgrid=SUBGRID,
        taper_beta=BETA, device=dev))
    # the parent design's times through the wrapper, from PERF.md §6 and
    # §5 (the f32 CUDA-core kernel on an H100 80GB HBM3 at 700 W)
    for label, ms, count, parent in (
            ("degridder kernel (CUDA)", ms_kernel, n_vis, "1.490-1.523"),
            ("degridder kernel (CUDA), IDG-AW track shape", ms_track, nT,
             "1.847 alone"),
            ("degridder plain (PyTorch)", ms_plain, n_vis, None),
            ("degrid prep (sort + CSR)", ms_prep, n_vis, None),
            ("idg_predict_vis end to end", ms_pred, n_vis, None),
            ("aw_idg_image end to end", ms_aw_img, nT, None),
            ("aw_predict_vis end to end", ms_aw_pred, nT, None)):
        was = f"; f32 design before: {parent} ms" if parent else ""
        print(f"time {label}: {ms:.3f} ms = {count / ms / 1e3:.2f} M vis/s "
              f"[{card}]{was}")
    S = SUBGRID
    n_runs = int(((drecs_full[1][1:] > drecs_full[1][:-1])
                  & (drecs_full[4] < PAIR_SHIFT)).sum())
    # per run the adjoint sandwich and the pair screen (12·S², as the
    # gridder's); records, run tables, order, screens and the model grid
    # read once, the visibilities written once
    io = nbytes(*drecs_full[:7], unit, grid_full) + n_vis * 8
    (f32_ms, f32_by), (bound_ms, bound_by, t_tc, t_cuda) = idg_stream_bounds(
        S, n_vis, n_runs, io)
    print(f"idg degridder bounds at S={S} ({n_runs} runs, {n_vis} records): "
          f"f32 {f32_ms:.3f} ms ({f32_by}); tensor core {bound_ms:.3f} ms "
          f"({bound_by}: split3 products {t_tc:.3f} ms at 989 TFLOP/s, "
          f"phase factors, weighting and screens {t_cuda:.3f} ms at 67 "
          f"TFLOP/s, bytes {io / HBM_BPS * 1e3:.3f} ms)")
    return {"launches": launches, "max_abs_err": max_abs, "ms": ms_kernel,
            "plain_ms": ms_plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}, model, truth


@functools.lru_cache(maxsize=1)
def bench_records():
    """The reference benchmark's bank-path inputs (``bench.py:93-97,
    212-223``): a random NW=32, QPX=8, 15² bank, centres on ±4000 λ, 2²⁰
    uniform records (uv within ±0.42·lam, w within ±3800 λ), visibilities
    and a random 2400² grid, from numpy seed 0; mirrored and binned as
    ``bench.py``'s ``_prep`` does.  Returns numpy arrays, drawn once and
    shared by the phases that use them."""
    nw, qpx, s, n_rec = 32, 8, 15, 1 << 20
    n_grid = int(round(THETA * LAM))
    rng = np.random.default_rng(0)
    bank = (rng.standard_normal((nw, qpx, qpx, s, s)).astype(np.float32)
            + 1j * rng.standard_normal((nw, qpx, qpx, s, s)).astype(
                np.float32)).astype(np.complex64)
    centers = np.linspace(-4000, 4000, nw).astype(np.float32)
    uvw = rng.uniform(-0.42 * LAM, 0.42 * LAM, size=(n_rec, 3))
    uvw[:, 2] = rng.uniform(-3800, 3800, size=n_rec)
    vis = (rng.standard_normal(n_rec).astype(np.float32)
           + 1j * rng.standard_normal(n_rec).astype(np.float32))
    grid = (rng.standard_normal((n_grid, n_grid)).astype(np.float32)
            + 1j * rng.standard_normal((n_grid, n_grid)).astype(np.float32))
    return dict(bank=bank, centers=centers, uvw=uvw.astype(np.float32),
                vis=vis.astype(np.complex64), grid=grid.astype(np.complex64))


def wproj_phases(torch, dev, card, vd, obs, img_idg, model, truth):
    """Phases 12-14.  ``vd``/``obs`` are the main path's observation,
    ``img_idg`` phase 4's IDG image, ``model`` and ``truth`` phase 8's
    snapped-source model and its float64 direct-DFT visibilities.  Returns
    the two kernels' entries of the ``kernels`` line."""
    from ska_sdp_tpu_torch.kernels import wproj
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.ops import (fft_centered, ifft_centered,
                                       make_grid_hermitian, mirror_uvw,
                                       uvw_lambda)
    from ska_sdp_tpu_torch.ops.gridding import convgrid_wproj, degrid_wproj
    from ska_sdp_tpu_torch.ops.search import find_closest

    chunk = 8192

    def both(bank, shape, p, wbin, vis, grid):
        """Kernel and plain results of the scatter and the gather."""
        g_k = wproj.wproj_gridder(bank, shape, p, wbin, vis)
        v_k = wproj.wproj_degridder(bank, grid, p, wbin)
        g_p = convgrid_wproj(bank, torch.zeros(shape, dtype=torch.complex64,
                                               device=dev), p, wbin, vis,
                             chunk=chunk)
        v_p = degrid_wproj(bank, grid, p, wbin, chunk=chunk)
        torch.cuda.synchronize()
        return g_k, v_k, g_p, v_p

    def parity(label, bank, shape, p, wbin, vis, grid):
        g_k, v_k, g_p, v_p = both(bank, shape, p, wbin, vis, grid)
        err_g = rel_l2(g_k.cpu().numpy(), g_p.cpu().numpy())
        err_v = rel_l2(v_k.cpu().numpy(), v_p.cpu().numpy())
        nw, qpx, _, gh, gw = bank.shape
        valid = wproj.wproj_records(shape, qpx, gh, gw, nw * qpx * qpx, p,
                                    wbin)[3]
        n_valid = int(valid.sum())
        nz_k, nz_p = int((v_k != 0).sum()), int((v_p != 0).sum())
        print(f"wproj parity {label}: grid rel-L2 {err_g:.3e}, vis rel-L2 "
              f"{err_v:.3e} (bound {KERNEL_TOL}); valid records "
              f"{n_valid} of {p.shape[0]}, nonzero predictions kernel "
              f"{nz_k} plain {nz_p}")
        if not (err_g <= KERNEL_TOL and err_v <= KERNEL_TOL):
            raise AssertionError(f"wproj parity {label} failed: {err_g}, "
                                 f"{err_v}")
        if not nz_k == nz_p == n_valid:
            raise AssertionError(f"wproj valid counts differ: {n_valid}, "
                                 f"{nz_k}, {nz_p}")
        return (float(np.abs(g_k.cpu().numpy() - g_p.cpu().numpy()).max()),
                float(np.abs(v_k.cpu().numpy() - v_p.cpu().numpy()).max()))

    def to_dev(*arrays):
        return [torch.as_tensor(a, device=dev) for a in arrays]

    # ---- 12a. mid-size parity, records beyond the edges -------------------
    rng = np.random.default_rng(21)
    n_mid = 200_000
    bank_mid = (rng.standard_normal((4, 4, 4, 15, 15))
                + 1j * rng.standard_normal((4, 4, 4, 15, 15))
                ).astype(np.complex64)
    p_mid = rng.uniform(-0.53, 0.53, (n_mid, 3)).astype(np.float32)
    wbin_mid = rng.integers(0, 4, n_mid).astype(np.int32)
    vis_mid = (rng.standard_normal(n_mid)
               + 1j * rng.standard_normal(n_mid)).astype(np.complex64)
    grid_mid = (rng.standard_normal((512, 512))
                + 1j * rng.standard_normal((512, 512))).astype(np.complex64)
    parity(f"mid (512², nw=4, qpx=4, {n_mid} records, |p| ≤ 0.53)",
           *to_dev(bank_mid), (512, 512),
           *to_dev(p_mid, wbin_mid, vis_mid, grid_mid))

    # ---- 12b/c. the benchmark's full-size shape, and the 4800² fold -------
    b = bench_records()
    bank_b, centers_b, uvw_b, vis_b, grid_b = to_dev(
        b["bank"], b["centers"], b["uvw"], b["vis"], b["grid"])
    uvw1, vis1 = mirror_uvw(uvw_b, vis_b)
    wbin_b = find_closest(centers_b, uvw1[:, 2])
    p_b = uvw1 / LAM
    n_b = p_b.shape[0]
    shape_b = tuple(grid_b.shape)
    max_abs_g, max_abs_v = parity(
        f"full ({shape_b[0]}², NW=32, QPX=8, 15², {n_b} records)", bank_b,
        shape_b, p_b, wbin_b, vis1, grid_b)
    n_lg = int(round(0.016 * LAM))
    grid_lg = torch.randn((n_lg, n_lg), dtype=torch.complex64, device=dev,
                          generator=torch.Generator(dev).manual_seed(3))
    parity(f"fold ({n_lg}², θ=0.016, the same records and bank)", bank_b,
           (n_lg, n_lg), p_b, wbin_b, vis1, grid_lg)
    del grid_lg

    # ---- 12d. skewed: every record in one output tile of the scatter ------
    n_sk = 1 << 18
    p_sk = torch.rand((n_sk, 3), device=dev,
                      generator=torch.Generator(dev).manual_seed(4))
    p_sk = (p_sk - 0.5) * torch.tensor([12 / shape_b[0], 12 / shape_b[1],
                                        7000.0], device=dev)
    wbin_sk = find_closest(centers_b, p_sk[:, 2])
    nw, qpx, _, gh, gw = bank_b.shape
    y0, x0, _, _ = wproj.wproj_records(shape_b, qpx, gh, gw, nw * qpx * qpx,
                                       p_sk, wbin_sk)
    _, items, _ = wproj.wproj_tile_plan(y0, x0, gh, gw, shape_b)
    _, g_items, _ = wproj.wproj_gather_plan(y0, x0, gh, gw, shape_b)
    tiles = torch.unique(items[0]).tolist()
    g_tiles = torch.unique(g_items[0]).tolist()
    if len(tiles) != 1 or len(g_tiles) != 1:
        raise AssertionError(f"skewed case spans tiles {tiles} (scatter), "
                             f"{g_tiles} (gather)")
    parity(f"skewed ({shape_b[0]}², the benchmark's bank, {n_sk} records "
           f"in one {wproj.TILE}² tile: {items.shape[1]} warp windows of the "
           f"scatter, {g_items.shape[1]} block windows of the gather)",
           bank_b, shape_b, p_sk, wbin_sk, vis1[:n_sk], grid_b)

    # ---- 13. main paths ----------------------------------------------------
    n_vis = vd.vis.shape[0]
    centers, build_bank = w_bank_inputs(torch, obs, dev)
    centers_t = torch.as_tensor(centers, device=dev)
    bank = build_bank()
    torch.cuda.synchronize()
    print(f"bank: {tuple(bank.shape)} {bank.dtype} built on the card for "
          f"w in ±{centers[-1]:.1f} λ")
    wproj.reset_launch_count()
    res = ds.w_image(vd, bank, centers, theta=THETA, lam=LAM, device=dev)
    torch.cuda.synchronize()
    launches_g = wproj.launch_count(wproj.GRID_KERNEL)
    img = res.image.cpu().numpy()
    n = img.shape[0]
    print(f"w main path: w_image {n}² from {n_vis} vis, image max "
          f"{res.image_max:.6g}, scatter launches {launches_g}")
    if not np.isfinite(img).all():
        raise AssertionError("w-projection image has non-finite pixels")
    if launches_g < 1:
        raise AssertionError("w_image did not launch the CUDA scatter")
    iy, ix = np.unravel_index(np.argmax(img), img.shape)
    srcs = obs["sources"]
    dists = [abs(iy - (n / 2 + m * LAM)) + abs(ix - (n / 2 + l * LAM))
             for l, m, _ in srcs]
    print(f"  peak at ({iy}, {ix}), L1 distance to nearest source "
          f"{min(dists):.2f} px (bound 3)")
    if min(dists) > 3.0:
        raise AssertionError("w image peak is not at a simulated source")
    for l, m, _ in srcs:
        cy, cx = int(round(n / 2 + m * LAM)), int(round(n / 2 + l * LAM))
        win = img[max(0, cy - 2):cy + 3, max(0, cx - 2):cx + 3]
        if not win.max() > 0.25 * img.max():
            raise AssertionError(f"source at ({l}, {m}) not recovered")
    print("  every source's 5×5 window above 0.25 of the image max")
    # the same pipeline with the plain scatter on the card
    bank64 = bank.to(torch.complex64)
    bank_conj = torch.conj(bank64).resolve_conj()
    cent32 = centers_t.to(torch.float32)
    uvw, f, vis = ds.idg_inputs(vd, device=dev)
    g = ds.idg_grid_inputs(uvw, f, vis, theta=THETA, lam=LAM)
    wbin = find_closest(cent32, g.w)
    guv_plain = convgrid_wproj(bank_conj, torch.zeros(
        g.grid_shape, dtype=torch.complex64, device=dev), g.p, wbin, g.vis,
        chunk=chunk)
    img_plain = ifft_centered(make_grid_hermitian(guv_plain)).real
    err_img = rel_l2(img, img_plain.cpu().numpy())
    print(f"  image vs plain-scatter pipeline: rel-L2 {err_img:.3e} (bound "
          f"{IMAGE_TOL}); vs phase 4's IDG image (no bound: another "
          f"approximation, no anti-aliasing taper): "
          f"{rel_l2(crop75(img), crop75(img_idg)):.3e} over the central 75%")
    if not err_img <= IMAGE_TOL:
        raise AssertionError(f"w image parity failed: {err_img}")

    wproj.reset_launch_count()
    pred = ds.w_predict_vis(vd, bank, centers, model, theta=THETA, lam=LAM,
                            device=dev)
    torch.cuda.synchronize()
    launches_d = wproj.launch_count(wproj.DEGRID_KERNEL)
    uvw0 = uvw_lambda(f, uvw)
    mgrid = fft_centered(torch.as_tensor(model, device=dev).to(
        torch.complex64))
    wbin0 = find_closest(cent32, uvw0[:, 2])
    v_plain = degrid_wproj(bank64, mgrid, uvw0 / LAM, wbin0, chunk=chunk)
    err_pred = rel_l2(pred.vis.cpu().numpy(), v_plain.cpu().numpy())
    got = pred.vis.to(torch.complex128)
    err_truth = float(torch.linalg.norm(got - truth)
                      / torch.linalg.norm(truth))
    print(f"w predict main path: w_predict_vis of phase 8's model to "
          f"{n_vis} vis, peak |vis| {pred.peak:.6g}, gather launches "
          f"{launches_d}; vs plain gather rel-L2 {err_pred:.3e} (bound "
          f"{KERNEL_TOL}); vs float64 direct DFT (no bound) {err_truth:.3e}")
    if not torch.isfinite(pred.vis).all():
        raise AssertionError("w prediction has non-finite values")
    if launches_d < 1:
        raise AssertionError("w_predict_vis did not launch the CUDA gather")
    if not err_pred <= KERNEL_TOL:
        raise AssertionError(f"w predict parity failed: {err_pred}")
    # the reference's predict degrids with the raw bank, which applies the
    # w phase with the opposite sign to the measurement equation; the
    # conjugated bank shows what the forward model would give (no bound)
    pred_c = ds.w_predict_vis(vd, torch.conj(bank).resolve_conj(), centers,
                              model, theta=THETA, lam=LAM, device=dev)
    err_c = float(torch.linalg.norm(pred_c.vis.to(torch.complex128) - truth)
                  / torch.linalg.norm(truth))
    print(f"  w predict with the conjugated bank vs float64 direct DFT (no "
          f"bound): {err_c:.3e}")

    # adjoint identity through both kernels, the same raw bank both ways
    G = torch.as_tensor(b["grid"], device=dev)
    Av = wproj.wproj_gridder(bank64, g.grid_shape, g.p, wbin, g.vis)
    AtG = wproj.wproj_degridder(bank64, G, g.p, wbin)
    lhs = torch.vdot(G.reshape(-1).to(torch.complex128),
                     Av.reshape(-1).to(torch.complex128)).item()
    rhs = torch.vdot(AtG.to(torch.complex128),
                     g.vis.to(torch.complex128)).item()
    err_adj = abs(lhs - rhs) / abs(lhs)
    print(f"w adjoint on the card: |<G, grid(v)> - <degrid(G), v>| / "
          f"|<G, grid(v)>| = {err_adj:.3e} (bound {ADJOINT_TOL})")
    if not err_adj <= ADJOINT_TOL:
        raise AssertionError(f"w adjoint identity failed: {err_adj}")

    # ---- 14. times -------------------------------------------------------
    zeros_b = torch.zeros(shape_b, dtype=torch.complex64, device=dev)
    ms = {
        "scatter kernel (CUDA)": timed_ms(torch, lambda: wproj.wproj_gridder(
            bank_b, shape_b, p_b, wbin_b, vis1)),
        "scatter plain (PyTorch)": timed_ms(torch, lambda: convgrid_wproj(
            bank_b, zeros_b, p_b, wbin_b, vis1, chunk=chunk)),
        "gather kernel (CUDA)": timed_ms(torch, lambda: wproj.wproj_degridder(
            bank_b, grid_b, p_b, wbin_b)),
        "gather plain (PyTorch)": timed_ms(torch, lambda: degrid_wproj(
            bank_b, grid_b, p_b, wbin_b, chunk=chunk)),
    }
    # the parent designs' times through the wrappers, from PERF.md §6 (an
    # H100 80GB HBM3 at 700 W): the gather before its tile sort
    parent = {"gather kernel (CUDA)": "1.208-1.427"}
    for label, t in ms.items():
        was = (f"; one warp a record in input order before: {parent[label]} "
               "ms" if label in parent else "")
        print(f"time {label} at the full-size shape: {t:.3f} ms = "
              f"{n_b / t / 1e3:.2f} M vis/s [{card}]{was}")
    for label, fn in (
            ("scatter kernel (CUDA), main-path records",
             lambda: wproj.wproj_gridder(bank_conj, g.grid_shape, g.p, wbin,
                                         g.vis)),
            ("gather kernel (CUDA), main-path records",
             lambda: wproj.wproj_degridder(bank64, mgrid, uvw0 / LAM,
                                           wbin0)),
            ("w_image end to end", lambda: ds.w_image(
                vd, bank, centers, theta=THETA, lam=LAM, device=dev)),
            ("w_predict_vis end to end", lambda: ds.w_predict_vis(
                vd, bank, centers, model, theta=THETA, lam=LAM,
                device=dev))):
        t = timed_ms(torch, fn)
        print(f"time {label}: {t:.3f} ms = {n_vis / t / 1e3:.2f} M vis/s "
              f"[{card}]")
    print(f"time bank build (32 planes, 2048² far field, float64): "
          f"{timed_ms(torch, build_bank):.3f} ms [{card}]")

    # bounds from this run's inputs: 8 flops per in-bounds tap, and the
    # wrapper's inputs read once and its output written once
    nw, qpx, _, gh, gw = bank_b.shape
    y0, x0, _, valid = wproj.wproj_records(shape_b, qpx, gh, gw,
                                           nw * qpx * qpx, p_b, wbin_b)
    rows = (torch.clamp(y0 + gh, max=shape_b[0]) - torch.clamp(y0, min=0))
    cols = (torch.clamp(x0 + gw, max=shape_b[1]) - torch.clamp(x0, min=0))
    taps = int((rows.clamp(min=0) * cols.clamp(min=0))[valid].sum())
    io = nbytes(bank_b, p_b, wbin_b, vis1, grid_b)
    entries = []
    for name, cu, replaces, launches, max_abs, key in (
            (wproj.GRID_KERNEL, "wproj_grid.cu",
             "ska_sdp_tpu/kernels/wproj_resident_pallas.py:76, "
             "ska_sdp_tpu/kernels/wproj_pallas.py:77", launches_g,
             max_abs_g, "scatter"),
            (wproj.DEGRID_KERNEL, "wproj_degrid.cu",
             "ska_sdp_tpu/kernels/wproj_degrid_resident_pallas.py:39, "
             "ska_sdp_tpu/kernels/wproj_degrid_pallas.py:47", launches_d,
             max_abs_v, "gather")):
        bound_ms, bound_by = bound(8 * taps, io)
        entries.append({
            "name": name, "route": "cuda",
            "source": f"ska_sdp_tpu_torch/csrc/{cu}", "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs,
            "ms": ms[f"{key} kernel (CUDA)"],
            "plain_ms": ms[f"{key} plain (PyTorch)"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    return entries, img


def aw_phases(torch, dev, card, vd, obs, img_w):
    """Phases 16-18.  ``vd``/``obs`` are the main path's observation and
    ``img_w`` phase 13's ``w_image``.  Returns the fused AW gridder's
    entry of the ``kernels`` line."""
    from ska_sdp_tpu_torch.kernels import aw_fused
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.ops import (doweight, ifft_centered,
                                       make_grid_hermitian, mirror_uvw,
                                       uvw_lambda)
    from ska_sdp_tpu_torch.ops.search import find_closest

    prep = aw_fused.aw_records_tables    # as aw_gridder builds them

    def parity(label, rec, pt, ws, vis, shape):
        placed = torch.zeros(1, dtype=torch.int32, device=dev)
        k = aw_fused.aw_fused_grid(pt, ws, rec, vis, shape, n_valid=placed)
        pl = aw_fused.aw_fused_plain(pt, ws, rec, vis, shape)
        torch.cuda.synchronize()
        kn, pn = k.cpu().numpy(), pl.cpu().numpy()
        err = rel_l2(kn, pn)
        n_valid, n_placed = int(rec.valid.sum()), int(placed)
        print(f"aw parity {label}: grid rel-L2 {err:.3e} (bound "
              f"{KERNEL_TOL}); valid records {n_valid} of {vis.shape[0]}, "
              f"placed by the kernel {n_placed}; pair rows {pt.shape[0]}")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"aw parity {label} failed: {err}")
        if n_placed != n_valid:
            raise AssertionError(f"aw valid counts differ: {n_valid}, "
                                 f"{n_placed}")
        return float(np.abs(kn - pn).max()), pl

    def to_dev(*arrays):
        return [torch.as_tensor(a, device=dev) for a in arrays]

    def cplx(rng, shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    # ---- 16a. mid-size parity, s = 15, 7 and 32; a skewed pair ----------
    for s, skew in ((15, False), (7, False), (32, False), (15, True)):
        rng = np.random.default_rng(40 + s)
        n_mid = 200_000
        wk, ak, p, wbin, a1, a2, vis = to_dev(
            cplx(rng, (4, 4, 4, s, s)), cplx(rng, (16, s, s)),
            rng.uniform(-0.53, 0.53, (n_mid, 3)).astype(np.float32),
            rng.integers(0, 4, n_mid).astype(np.int32),
            rng.integers(0, 16, n_mid).astype(np.int32),
            rng.integers(0, 16, n_mid).astype(np.int32), cplx(rng, n_mid))
        label = (f"mid (512², s={s}, 16 ant, nw=4, qpx=4, {n_mid} records, "
                 "|p| ≤ 0.53")
        if skew:   # half the records on one pair: its run in many items
            a1[::2], a2[::2] = 3, 5
            label += f", {n_mid // 2} of them on one pair"
        rec, pt, ws = prep(wk, ak, (512, 512), p, wbin, a1, a2)
        parity(label + ")", rec, pt, ws, vis, (512, 512))

    # ---- 16b/c. the benchmark's fused-AW shape, and the 4800² fold --------
    # the benchmark's first 524,288 records, as bench.py:726 slices them
    n_b = 1 << 19
    b = bench_records()
    rng = np.random.default_rng(1)
    bank_b, centers_b, uvw_b, vis_b, ak_b, a1_b, a2_b = to_dev(
        b["bank"], b["centers"], b["uvw"][:n_b], b["vis"][:n_b],
        cplx(rng, (64, 15, 15)),
        rng.integers(0, 64, n_b).astype(np.int32),
        rng.integers(0, 64, n_b).astype(np.int32))
    uvw1_b, vis1_b = mirror_uvw(uvw_b, vis_b)
    wbin_b = find_closest(centers_b, uvw1_b[:, 2])
    p_b = uvw1_b / LAM
    n_grid = int(round(THETA * LAM))
    shape_b = (n_grid, n_grid)
    rec_b, pt_b, ws_b = prep(bank_b, ak_b, shape_b, p_b, wbin_b, a1_b, a2_b)
    parity(f"bench ({n_grid}², NW=32, QPX=8, 15², 64 ant, {n_b} records)",
           rec_b, pt_b, ws_b, vis1_b, shape_b)
    n_lg = int(round(0.016 * LAM))
    rec_lg, pt_lg, ws_lg = prep(bank_b, ak_b, (n_lg, n_lg), p_b, wbin_b,
                                a1_b, a2_b)
    parity(f"fold ({n_lg}², θ=0.016, the same records and tables)", rec_lg,
           pt_lg, ws_lg, vis1_b, (n_lg, n_lg))
    del rec_lg, pt_lg, ws_lg

    # ---- 16d/17. the main path: 512 stations ------------------------------
    n_vis = vd.vis.shape[0]
    centers, build_bank = w_bank_inputs(torch, obs, dev)
    bank = build_bank()
    ak_main = main_akerns()
    # the same pipeline as aw_image, on the tables and records the kernel
    # gets, for the shape (d) parity and the plain image
    uvw, f, vis = ds.idg_inputs(vd, device=dev)
    uvw0 = uvw_lambda(f, uvw)
    wt = doweight(THETA, LAM, uvw0, torch.ones_like(vis))
    uvw1, vis1 = mirror_uvw(uvw0, vis)
    a1, a2 = to_dev(vd.antenna1.astype(np.int32),
                    vd.antenna2.astype(np.int32))
    wbin = find_closest(torch.as_tensor(centers, dtype=torch.float32,
                                        device=dev), uvw1[:, 2])
    bank64 = bank.to(torch.complex64)
    ak64 = torch.as_tensor(ak_main, dtype=torch.complex64, device=dev)
    shape = (n_grid, n_grid)
    rec_d, pt_d, ws_d = prep(bank64, ak64, shape, uvw1 / LAM, wbin, a1, a2)
    vis_d = wt * vis1
    max_abs, guv_plain = parity(
        f"main ({n_grid}², 32 planes, qpx=8, 15², 512 stations, {n_vis} "
        "vis)", rec_d, pt_d, ws_d, vis_d, shape)
    img_plain = ifft_centered(make_grid_hermitian(guv_plain)).real
    img_plain = img_plain.cpu().numpy()

    aw_fused.reset_launch_count()
    res = ds.aw_image(vd, bank, centers, ak_main, theta=THETA, lam=LAM,
                      device=dev)
    torch.cuda.synchronize()
    launches = aw_fused.launch_count(aw_fused.GRID_KERNEL)
    img = res.image.cpu().numpy()
    n = img.shape[0]
    print(f"aw main path: aw_image {n}² from {n_vis} vis, 512 near-delta "
          f"A-kernels, image max {res.image_max:.6g}, kernel launches "
          f"{launches}")
    if not np.isfinite(img).all():
        raise AssertionError("AW image has non-finite pixels")
    if launches < 1:
        raise AssertionError("aw_image did not launch the CUDA AW gridder")
    iy, ix = np.unravel_index(np.argmax(img), img.shape)
    srcs = obs["sources"]
    dists = [abs(iy - (n / 2 + m * LAM)) + abs(ix - (n / 2 + l * LAM))
             for l, m, _ in srcs]
    print(f"  peak at ({iy}, {ix}), L1 distance to nearest source "
          f"{min(dists):.2f} px (bound 3)")
    if min(dists) > 3.0:
        raise AssertionError("AW image peak is not at a simulated source")
    for l, m, _ in srcs:
        cy, cx = int(round(n / 2 + m * LAM)), int(round(n / 2 + l * LAM))
        win = img[max(0, cy - 2):cy + 3, max(0, cx - 2):cx + 3]
        if not win.max() > 0.25 * img.max():
            raise AssertionError(f"source at ({l}, {m}) not recovered")
    print("  every source's 5×5 window above 0.25 of the image max")
    err_img = rel_l2(crop75(img), crop75(img_plain))
    print(f"  image vs plain-kernel pipeline: rel-L2 {err_img:.3e} over the "
          f"central 75% (bound {IMAGE_TOL}); vs phase 13's w_image (no "
          f"bound: near-delta A-kernels): "
          f"{rel_l2(crop75(img), crop75(img_w)):.3e}")
    if not err_img <= IMAGE_TOL:
        raise AssertionError(f"AW image parity failed: {err_img}")

    # ---- 18. times ----------------------------------------------------------
    ms = {}
    for label, count, fn in (
            ("kernel (CUDA), bench shape", n_b, lambda: aw_fused.aw_fused_grid(
                pt_b, ws_b, rec_b, vis1_b, shape_b)),
            ("plain (PyTorch), bench shape", n_b,
             lambda: aw_fused.aw_fused_plain(pt_b, ws_b, rec_b, vis1_b,
                                             shape_b)),
            ("kernel (CUDA), main path", n_vis,
             lambda: aw_fused.aw_fused_grid(pt_d, ws_d, rec_d, vis_d, shape)),
            ("plain (PyTorch), main path", n_vis,
             lambda: aw_fused.aw_fused_plain(pt_d, ws_d, rec_d, vis_d,
                                             shape)),
            ("tables, 64 stations", n_b, lambda: prep(
                bank_b, ak_b, shape_b, p_b, wbin_b, a1_b, a2_b)),
            ("tables, 512 stations", n_vis, lambda: prep(
                bank64, ak64, shape, uvw1 / LAM, wbin, a1, a2)),
            ("aw_image end to end", n_vis, lambda: ds.aw_image(
                vd, bank, centers, ak_main, theta=THETA, lam=LAM,
                device=dev))):
        ms[label] = t = timed_ms(torch, fn)
        print(f"time aw {label}: {t:.3f} ms = {count / t / 1e3:.2f} M vis/s "
              f"[{card}]")

    # bound from this run's inputs: the operations of the valid records,
    # and the wrapper's inputs read once and the grid written once.  Per
    # record, P⊙Ŵ is 6m² flop and vis·conj(patch) 6s²; the sandwich
    # S·X·Sᵀ is either dense (8·(m²s + s²m): m rows then s columns of
    # complex multiply-adds) or, since S is s rows of a centred m-point
    # DFT times m, radix-2 FFTs of the m rows and then of the s kept
    # columns, 5·m·log2(m) flop each: (m + s)·5·m·log2(m).  The smaller
    # count is the least work the function needs (the FFT's at s=15,
    # m=32: 45,094 against 187,974 flop per record).
    s, m = 15, pt_d.shape[-1]
    per_rec_dense = 8 * (m * m * s + s * s * m) + 6 * m * m + 6 * s * s
    per_rec_fft = ((m + s) * 5 * m * int(math.log2(m)) + 6 * m * m
                   + 6 * s * s)
    n_valid = int(rec_d.valid.sum())
    ops = n_valid * min(per_rec_dense, per_rec_fft)
    io = (nbytes(pt_d, ws_d, rec_d.y0, rec_d.x0, rec_d.pid, rec_d.kidx,
                 vis_d) + shape[0] * shape[1] * 8)
    bound_ms, bound_by = bound(ops, io)
    print(f"aw_grid bound at the main path: {n_valid} valid records x "
          f"{min(per_rec_dense, per_rec_fft)} flop (dense sandwich "
          f"{per_rec_dense}, FFT sandwich {per_rec_fft}) = "
          f"{ops / 1e9:.1f} GFLOP, {io / 1e6:.1f} MB -> {bound_ms:.3f} ms "
          f"({bound_by}; dense count "
          f"{bound(n_valid * per_rec_dense, io)[0]:.3f} ms)")
    return {
        "name": aw_fused.GRID_KERNEL, "route": "cuda",
        "source": "ska_sdp_tpu_torch/csrc/aw_grid.cu",
        "replaces": "ska_sdp_tpu/kernels/aw_fused_resident_pallas.py:95, "
                    "ska_sdp_tpu/kernels/aw_fused_pallas.py:93, "
                    "ska_sdp_tpu/kernels/patch_scatter_pallas.py:41",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms["kernel (CUDA), main path"],
        "plain_ms": ms["plain (PyTorch), main path"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def tile_phases(torch, dev, card, vd, obs, img64, model, truth):
    """Phases 20-22.  ``vd``/``obs`` are the main path's observation,
    ``img64`` phase 4's S=64 ``idg_image``, ``model`` and ``truth`` phase
    8's snapped-source model and its float64 direct-DFT visibilities.
    Returns the two fixed-tile kernels' entries of the ``kernels`` line."""
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.kernels import idg_tile
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.utils.timing import PhaseTimer

    S32 = 32
    kw32 = dict(subgrid=S32, taper_beta=BETA)

    def grid_both(shape, p, w, vis, S, support, theta):
        recs, starts = idg_tile.idg_bin_records(
            shape, p, w, vis.real, vis.imag, subgrid=S, support=support)
        geo = idg_tile.tile_geometry(shape, S)
        kw = dict(theta=theta, subgrid=S, taper_beta=BETA)
        k = idg_tile.idg_grid_from_records(recs, starts, shape, **kw)
        pl = idg_tile.grid_from_records_plain(
            recs, starts, grid_shape=shape, **kw)[
                geo.T:geo.T + shape[0], geo.T:geo.T + shape[1]]
        torch.cuda.synchronize()
        return recs, starts, k, pl

    def degrid_both(p, w, grid, S, support, theta):
        shape = tuple(grid.shape)
        recs, starts, order, valid = idg_tile.prep_with_order(
            shape, p, w, subgrid=S, support=support)
        k = idg_tile.idg_degrid_from_records(recs, starts, order, grid,
                                             theta=theta, subgrid=S,
                                             taper_beta=BETA)
        a_sub, occ = idg_tile.tile_images(grid, starts, subgrid=S,
                                          taper_beta=BETA)
        pl = idg_tile.degrid_from_records_plain(
            recs, starts, order, occ, a_sub, grid_shape=shape, theta=theta,
            subgrid=S)
        torch.cuda.synchronize()
        return (recs, starts, order, valid, a_sub, occ), k, pl

    def parity(label, shape, S, support, theta, g_in, d_in):
        recs, starts, gk, gp_t = grid_both(shape, *g_in, S, support, theta)
        drecs, vk, vp = degrid_both(*d_in, S, support, theta)
        gk, gp, vk, vp = (x.cpu().numpy() for x in (gk, gp_t, vk, vp))
        err_g, err_v = rel_l2(gk, gp), rel_l2(vk, vp)
        valid = drecs[3].cpu().numpy()
        n_occ = int((starts[1:] > starts[:-1]).sum())
        print(f"tile parity {label}: grid rel-L2 {err_g:.3e}, vis rel-L2 "
              f"{err_v:.3e} (bound {KERNEL_TOL}); {int(valid.sum())} of "
              f"{valid.shape[0]} records on the grid, {n_occ} of "
              f"{starts.shape[0] - 1} subgrids occupied; nonzero "
              f"predictions kernel {int((vk != 0).sum())} plain "
              f"{int((vp != 0).sum())}")
        if not (err_g <= KERNEL_TOL and err_v <= KERNEL_TOL):
            raise AssertionError(f"tile parity {label} failed: {err_g}, "
                                 f"{err_v}")
        if np.any(vk[~valid] != 0) or np.any(vp[~valid] != 0):
            raise AssertionError(f"tile parity {label}: off-grid records "
                                 "predicted nonzero")
        return dict(recs=recs, starts=starts, drecs=drecs, gp=gp_t, vp=vp,
                    max_abs_g=float(np.abs(gk - gp).max()),
                    max_abs_v=float(np.abs(vk - vp).max()), n_occ=n_occ)

    # ---- 20a. 512² at S = 16, 32, 48, 128, records beyond the edges ------
    mid_lam = 64000                                     # 512² at θ=0.008
    rng = np.random.default_rng(50)
    n_mid = 200_000
    p_mid = rng.uniform(-0.53, 0.53, (n_mid, 3)).astype(np.float32)
    w_mid = rng.uniform(-1e5, 1e5, n_mid).astype(np.float32)
    vis_mid = (rng.standard_normal(n_mid)
               + 1j * rng.standard_normal(n_mid)).astype(np.complex64)
    g_mid = (rng.standard_normal((512, 512))
             + 1j * rng.standard_normal((512, 512))).astype(np.complex64)
    pm, wm, vm, gm = (torch.as_tensor(a, device=dev)
                      for a in (p_mid, w_mid, vis_mid, g_mid))
    for S, support in ((16, 7), (32, 15), (48, 15), (128, 15)):
        parity(f"mid (512², S={S}, support {support}, {n_mid} records, "
               "|p| ≤ 0.53)", (512, 512), S, support, THETA,
               (pm, wm, vm), (pm, wm, gm))
    del pm, wm, vm, gm

    # ---- 20b. the main path's records at S=32 ------------------------------
    n_vis = vd.vis.shape[0]
    uvw, f, vis = ds.idg_inputs(vd, device=dev)
    g = ds.idg_grid_inputs(uvw, f, vis, theta=THETA, lam=LAM)
    model_t = torch.as_tensor(model, device=dev)
    d = ds.degrid_inputs(model_t, uvw, f, theta=THETA, lam=LAM, **kw32)
    shape = g.grid_shape
    main = parity(f"main ({shape[0]}², S=32, support 15, {n_vis} records; "
                  "phase 8's model grid)", shape, S32, SUPPORT, g.theta,
                  (g.p, g.w, g.vis), (d.p, d.w, d.grid))

    # ---- 21a. idg_image at S=32 --------------------------------------------
    stream.reset_launch_count()
    idg_tile.reset_launch_count()
    res = ds.idg_image(vd, theta=THETA, lam=LAM, device=dev, **kw32)
    torch.cuda.synchronize()
    launches_g = idg_tile.launch_count(idg_tile.GRID_KERNEL)
    launches_stream = stream.launch_count(stream.GRID_KERNEL)
    img = res.image.cpu().numpy()
    n = img.shape[0]
    print(f"S=32 main path: idg_image {n}² from {n_vis} vis, image max "
          f"{res.image_max:.6g}, n_dropped {res.n_dropped}, fixed-tile "
          f"launches {launches_g}, streamed launches {launches_stream}")
    if not np.isfinite(img).all():
        raise AssertionError("S=32 image has non-finite pixels")
    if res.n_dropped != 0:
        raise AssertionError(f"S=32 imaging dropped {res.n_dropped}")
    if launches_g < 1 or launches_stream != 0:
        raise AssertionError("idg_image(subgrid=32) did not run on the "
                             "fixed-tile kernel alone")
    iy, ix = np.unravel_index(np.argmax(crop75(img)), crop75(img).shape)
    iy, ix = iy + n // 8, ix + n // 8
    srcs = obs["sources"]
    dists = [abs(iy - (n / 2 + m * LAM)) + abs(ix - (n / 2 + l * LAM))
             for l, m, _ in srcs]
    print(f"  peak of the central 75% at ({iy}, {ix}), L1 distance to "
          f"nearest source {min(dists):.2f} px (bound 3)")
    if min(dists) > 3.0:
        raise AssertionError("S=32 image peak is not at a simulated source")
    for l, m, _ in srcs:
        cy, cx = int(round(n / 2 + m * LAM)), int(round(n / 2 + l * LAM))
        win = img[max(0, cy - 2):cy + 3, max(0, cx - 2):cx + 3]
        if not win.max() > 0.25 * crop75(img).max():
            raise AssertionError(f"source at ({l}, {m}) not recovered")
    print("  every source's 5×5 window above 0.25 of the central max")
    img_plain = ds._idg_finish(main["gp"], g.n, shape[0], g.crop_lo, S32,
                               BETA).cpu().numpy()
    err_img = rel_l2(crop75(img), crop75(img_plain))
    print(f"  image vs plain fixed-tile pipeline: rel-L2 {err_img:.3e} over "
          f"the central 75% (bound {IMAGE_TOL}); vs phase 4's S=64 image "
          f"(no bound): {rel_l2(crop75(img), crop75(img64)):.3e}")
    if not err_img <= IMAGE_TOL:
        raise AssertionError(f"S=32 image parity failed: {err_img}")

    # ---- 21b. idg_predict_vis at S=32 --------------------------------------
    stream.reset_launch_count()
    idg_tile.reset_launch_count()
    pred = ds.idg_predict_vis(vd, model, theta=THETA, lam=LAM, device=dev,
                              **kw32)
    torch.cuda.synchronize()
    launches_d = idg_tile.launch_count(idg_tile.DEGRID_KERNEL)
    launches_stream = stream.launch_count(stream.DEGRID_KERNEL)
    err_pred = rel_l2(pred.vis.cpu().numpy(), main["vp"])
    got = pred.vis.to(torch.complex128)
    err_truth = float(torch.linalg.norm(got - truth)
                      / torch.linalg.norm(truth))
    print(f"S=32 predict main path: idg_predict_vis of phase 8's model to "
          f"{n_vis} vis, peak |vis| {pred.peak:.6g}, n_dropped "
          f"{pred.n_dropped}, fixed-tile launches {launches_d}, streamed "
          f"launches {launches_stream}; vs plain fixed-tile degridder "
          f"rel-L2 {err_pred:.3e} (bound {KERNEL_TOL}); vs float64 direct "
          f"DFT {err_truth:.3e} (the reference's S=32 bound 3e-4)")
    if not torch.isfinite(pred.vis).all():
        raise AssertionError("S=32 prediction has non-finite values")
    if pred.n_dropped != 0:
        raise AssertionError(f"S=32 predict dropped {pred.n_dropped}")
    if launches_d < 1 or launches_stream != 0:
        raise AssertionError("idg_predict_vis(subgrid=32) did not run on "
                             "the fixed-tile kernel alone")
    if not err_pred <= KERNEL_TOL:
        raise AssertionError(f"S=32 predict parity failed: {err_pred}")

    # ---- 21c. the stage-timed pipeline at S=64 -----------------------------
    timer = PhaseTimer()
    idg_tile.reset_launch_count()
    img_st, _ = ds._idg_staged(uvw, f, vis, theta=THETA, lam=LAM,
                               subgrid=SUBGRID, taper_beta=BETA, timer=timer)
    torch.cuda.synchronize()
    launches_st = idg_tile.launch_count(idg_tile.GRID_KERNEL)
    err_st = rel_l2(crop75(img_st.cpu().numpy()), crop75(img64))
    stages = ", ".join(f"{k[7:]} {v * 1e3:.3f} ms"
                       for k, v in timer.times.items()
                       if k.startswith("device/") and "+compile" not in k)
    print(f"staged S=64 (_idg_staged, in memory): vs phase 4's idg_image "
          f"rel-L2 {err_st:.3e} over the central 75% (bound {IMAGE_TOL}), "
          f"fixed-tile launches {launches_st} (warm-up + timed); stages: "
          f"{stages} [{card}]")
    if launches_st < 1:
        raise AssertionError("_idg_staged did not launch the fixed-tile "
                             "gridder")
    if not err_st <= IMAGE_TOL:
        raise AssertionError(f"staged image parity failed: {err_st}")

    # ---- 22. times at S=32 on the main path --------------------------------
    recs, starts = main["recs"], main["starts"]
    drecs, dstarts, order, _, a_sub, occ = main["drecs"]
    gkw = dict(grid_shape=shape, theta=g.theta, subgrid=S32)
    dkw = dict(grid_shape=shape, theta=d.theta, subgrid=S32)
    it = idg_tile
    ms = {}
    for label, fn in (
            ("gridder kernel (CUDA)", lambda: it.idg_grid_from_records(
                recs, starts, shape, theta=g.theta, **kw32)),
            ("gridder plain (PyTorch)", lambda: it.grid_from_records_plain(
                recs, starts, taper_beta=BETA, **gkw)),
            ("degridder kernel (CUDA)",
             lambda: it._degrid_from_records_cuda(
                 drecs, dstarts, order, occ, a_sub, **dkw)),
            ("degridder plain (PyTorch)",
             lambda: it.degrid_from_records_plain(
                 drecs, dstarts, order, occ, a_sub, **dkw)),
            ("degrid prologue (window sandwiches)", lambda: it.tile_images(
                d.grid, dstarts, **kw32)),
            ("gridder prep (bin + sort)", lambda: it.idg_bin_records(
                shape, g.p, g.w, g.vis.real, g.vis.imag, subgrid=S32)),
            ("degridder prep (bin + sort + order)",
             lambda: it.prep_with_order(shape, d.p, d.w, subgrid=S32)),
            ("idg_image(subgrid=32) end to end", lambda: ds.idg_image(
                vd, theta=THETA, lam=LAM, device=dev, **kw32)),
            ("idg_predict_vis(subgrid=32) end to end",
             lambda: ds.idg_predict_vis(vd, model, theta=THETA, lam=LAM,
                                        device=dev, **kw32))):
        ms[label] = t = timed_ms(torch, fn)
        print(f"time tile {label}: {t:.3f} ms = {n_vis / t / 1e3:.2f} M "
              f"vis/s [{card}]")

    # bounds from this run's inputs: 8·S² flop per record in a subgrid and
    # the least sandwich count per occupied subgrid (the gridder's; the
    # degridder's is its prologue, outside the kernel), each input read
    # once and each output written once
    n_in, n_din = int(starts[-1]), int(dstarts[-1])
    HP, WP = idg_tile.tile_geometry(shape, S32).padded_shape
    sw = sandwich_flop(S32)
    g_io = nbytes(recs, starts) + HP * WP * 8
    g_ops = 8 * S32 ** 2 * n_in + sw[0] * main["n_occ"]
    g_bound = bound(g_ops, g_io)
    g_dense = bound(8 * S32 ** 2 * n_in + sw[1] * main["n_occ"], g_io)[0]
    print(f"tile gridder sandwich at S=32: {main['n_occ']} subgrids x "
          f"{sw[0]:.0f} flop (dense {sw[1]:.0f}, FFT {sw[2]:.0f}); dense "
          f"count {g_dense:.3f} ms")
    d_bound = bound(8 * S32 ** 2 * n_din,
                    nbytes(drecs, dstarts, order, occ, a_sub) + n_vis * 8)
    for label, (b_ms, b_by), ops in (("gridder", g_bound, g_ops),
                                     ("degridder", d_bound,
                                      8 * S32 ** 2 * n_din)):
        print(f"tile {label} bound at S=32: {ops / 1e9:.2f} GFLOP -> "
              f"{b_ms:.3f} ms ({b_by}); the kernel at "
              f"{100 * b_ms / ms[label + ' kernel (CUDA)']:.1f}% of it")
    return [{
        "name": idg_tile.GRID_KERNEL, "route": "cuda",
        "source": "ska_sdp_tpu_torch/csrc/idg_tile_grid.cu",
        "replaces": "ska_sdp_tpu/kernels/idg_pallas.py:49",
        "launches": launches_g, "max_abs_err": main["max_abs_g"],
        "ms": ms["gridder kernel (CUDA)"],
        "plain_ms": ms["gridder plain (PyTorch)"],
        "bound_ms": g_bound[0], "bound_by": g_bound[1], "library_ms": None,
    }, {
        "name": idg_tile.DEGRID_KERNEL, "route": "cuda",
        "source": "ska_sdp_tpu_torch/csrc/idg_tile_degrid.cu",
        "replaces": "ska_sdp_tpu/kernels/idg_degrid_pallas.py:41",
        "launches": launches_d, "max_abs_err": main["max_abs_v"],
        "ms": ms["degridder kernel (CUDA)"],
        "plain_ms": ms["degridder plain (PyTorch)"],
        "bound_ms": d_bound[0], "bound_by": d_bound[1], "library_ms": None,
    }]


@contextlib.contextmanager
def plain_kernels(torch):
    """Route the cube entries (``models/spectral.py``) through the plain
    versions of their three kernels, on the tensors' own device."""
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.kernels import idg_tile
    from ska_sdp_tpu_torch.models import spectral as sp
    from ska_sdp_tpu_torch.ops.gridding import convgrid_wproj

    def streamed(recs, st, en, y0, x0, i1, i2, shape, scr, *, theta,
                 subgrid, taper_beta):
        g = stream.grid_from_records_plain(
            recs, st, en, y0, x0, i1, i2, scr, grid_shape=shape, theta=theta,
            subgrid=subgrid, taper_beta=taper_beta)
        return g[subgrid:subgrid + shape[0], subgrid:subgrid + shape[1]]

    def tile(recs, starts, shape, *, theta, subgrid, taper_beta):
        T = subgrid // 2
        g = idg_tile.grid_from_records_plain(
            recs, starts, grid_shape=shape, theta=theta, subgrid=subgrid,
            taper_beta=taper_beta)
        return g[T:T + shape[0], T:T + shape[1]]

    def scatter(bank_conj, shape, p, wbin, vis, chunk):
        return convgrid_wproj(bank_conj, torch.zeros(
            shape, dtype=vis.dtype, device=vis.device), p, wbin, vis,
            chunk=chunk)

    names = ("idg_aw_grid_from_records_stream", "idg_grid_from_records",
             "wproj_gridder")
    saved = [getattr(sp, k) for k in names]
    for k, fn in zip(names, (streamed, tile, scatter)):
        setattr(sp, k, fn)
    try:
        yield
    finally:
        for k, fn in zip(names, saved):
            setattr(sp, k, fn)


def peak_at_source(img, srcs, label):
    """The peak of the central 75% must lie within 3 px (L1) of a source."""
    n = img.shape[0]
    c = crop75(img)
    iy, ix = np.unravel_index(np.argmax(c), c.shape)
    iy, ix = iy + n // 8, ix + n // 8
    d = min(abs(iy - (n / 2 + m * LAM)) + abs(ix - (n / 2 + l * LAM))
            for l, m, _ in srcs)
    print(f"  {label}: peak of the central 75% at ({iy}, {ix}), L1 "
          f"distance to nearest source {d:.2f} px (bound 3)")
    if d > 3.0:
        raise AssertionError(f"{label}: peak is not at a simulated source")


def spectral_phases(torch, dev, card, mid):
    """Phases 23-25.  ``mid`` holds phase 3a's 512² IDG-AW inputs."""
    from ska_sdp_tpu_torch.kernels import idg_aw_records as awr
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.kernels import idg_tile, wproj
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.models import spectral as sp
    from ska_sdp_tpu_torch.ops.search import find_closest

    S = SUBGRID

    # ---- 23. spectral kernel parity at 512² -------------------------------
    shape, n_mid = mid["shape"], mid["n"]
    rng = np.random.default_rng(23)
    ratios = (0.97, 0.99, 1.01, 1.03)
    vis4 = torch.as_tensor((rng.standard_normal((4, n_mid))
                            + 1j * rng.standard_normal((4, n_mid))
                            ).astype(np.complex64), device=dev)

    def cut(g, m):
        return g[m:m + shape[0], m:m + shape[1]]

    for drift in (7, 0):
        base, vis_s, *runs, nd0, _ = awr.idg_aw_run_records_multi(
            shape, mid["p"], mid["a1"], mid["a2"], mid["w"], vis4.real,
            vis4.imag, subgrid=S, support=SUPPORT, max_runs=65536,
            drift_cells=drift)
        errs, masked = [], []
        for c, r in enumerate(ratios):
            recs, nm = awr.idg_aw_records_for_channel(base, vis_s[c], r,
                                                      subgrid=S)
            k = stream.idg_aw_grid_from_records_stream(
                recs, *runs, shape, mid["scr"], theta=THETA, subgrid=S,
                taper_beta=BETA)
            pl = cut(stream.grid_from_records_plain(
                recs, *runs, mid["scr"], grid_shape=shape, theta=THETA,
                subgrid=S, taper_beta=BETA), S)
            errs.append(rel_l2(k.cpu().numpy(), pl.cpu().numpy()))
            masked.append(int(nm))
        print(f"spectral parity (512², S=64, 16 ant, {n_mid} records, random "
              f"screens, drift_cells {drift}, r {ratios}): idg_grid vs plain "
              f"rel-L2 per channel {', '.join(f'{e:.3e}' for e in errs)} "
              f"(bound {KERNEL_TOL}); n_masked per channel {masked} (the same "
              f"records both ways), prep dropped {int(nd0)}")
        if max(errs) > KERNEL_TOL or int(nd0) != 0:
            raise AssertionError(f"spectral parity failed: {errs}, {int(nd0)}")
        if (drift == 7) == (sum(masked) > 0):
            raise AssertionError(f"unexpected masks at drift {drift}: "
                                 f"{masked}")
    base, vis_s, starts = idg_tile.idg_bin_records_multi(
        shape, mid["p"], mid["w"], vis4.real, vis4.imag, subgrid=32,
        support=SUPPORT)
    errs, masked = [], []
    for c, r in enumerate(ratios):
        recs, nm = idg_tile.idg_records_for_channel(base, vis_s[c], r,
                                                    subgrid=32)
        k = idg_tile.idg_grid_from_records(recs, starts, shape, theta=THETA,
                                           subgrid=32, taper_beta=BETA)
        pl = cut(idg_tile.grid_from_records_plain(
            recs, starts, grid_shape=shape, theta=THETA, subgrid=32,
            taper_beta=BETA), 16)
        errs.append(rel_l2(k.cpu().numpy(), pl.cpu().numpy()))
        masked.append(int(nm))
    print(f"spectral parity, fixed-tile multi prep (512², S=32): "
          f"idg_tile_grid vs plain rel-L2 per channel "
          f"{', '.join(f'{e:.3e}' for e in errs)} (bound {KERNEL_TOL}); "
          f"n_masked per channel {masked}")
    if max(errs) > KERNEL_TOL:
        raise AssertionError(f"fixed-tile spectral parity failed: {errs}")
    del vis4, base, vis_s

    # ---- 24. the cube main paths at full width ----------------------------
    obs_c, vd_c = cube_observation()
    n_c, nch = vd_c.uvw.shape[0], vd_c.frequencies.shape[0]
    n = int(round(THETA * LAM))
    centers, build_bank = w_bank_inputs(torch, obs_c, dev)
    bank = build_bank()
    vd_aw, ak = aw_cube_inputs(), cube_akerns()
    counted = {"idg_grid": (stream, stream.GRID_KERNEL),
               "idg_tile_grid": (idg_tile, idg_tile.GRID_KERNEL),
               "wproj_grid": (wproj, wproj.GRID_KERNEL)}
    kw = dict(theta=THETA, lam=LAM, device=dev)
    cubes = {
        "idg_cube S=64": (lambda: sp.idg_cube(vd_c, subgrid=S,
                                              taper_beta=BETA, **kw),
                          "idg_grid", True),
        "idg_cube S=32": (lambda: sp.idg_cube(vd_c, subgrid=32,
                                              taper_beta=BETA, **kw),
                          "idg_tile_grid", True),
        "w_cube": (lambda: sp.w_cube(vd_c, bank, centers, **kw),
                   "wproj_grid", False),
        "aw_idg_cube S=64": (lambda: sp.aw_idg_cube(vd_aw, ak, subgrid=S,
                                                    taper_beta=BETA, **kw),
                             "idg_grid", True),
    }
    results = {}
    for label, (fn, kernel, central) in cubes.items():
        for mod, _ in counted.values():
            mod.reset_launch_count()
        res = fn()
        torch.cuda.synchronize()
        launches = {k: mod.launch_count(kn)
                    for k, (mod, kn) in counted.items()}
        with plain_kernels(torch):
            ref = fn()
        cube, ref_c = res.cube.cpu().numpy(), ref.cube.cpu().numpy()
        sel = crop75 if central else (lambda a: a)
        errs = [rel_l2(sel(cube[c]), sel(ref_c[c])) for c in range(nch)]
        drops = res.dropped.tolist()
        plan = [(i, j, round(float(f) / 1e6, 3), d)
                for i, j, f, d in res.groups]
        print(f"{label}: {nch} channels x {n_c} records, groups (start, "
              f"stop, f_ref MHz, drift cells) {plan}, branches "
              f"{res.branches}, launches {launches}, dropped per channel "
              f"{drops} ({100 * sum(drops) / (nch * n_c):.3f}% of "
              f"channel-visibilities), continuum max {res.image_max:.6g}; "
              f"vs the same entry on the plain kernels max rel-L2 "
              f"{max(errs):.3e} (bound {IMAGE_TOL}"
              f"{', central 75%' if central else ''})")
        if not np.isfinite(cube).all():
            raise AssertionError(f"{label} has non-finite pixels")
        if launches[kernel] != nch or sum(launches.values()) != nch:
            raise AssertionError(f"{label} launches {launches}, not {nch} "
                                 f"of {kernel}")
        if drops != ref.dropped.tolist():
            raise AssertionError(f"{label}: drops differ from the plain run")
        # S=32's centred window has no slack below: the reference's own
        # drops, counted; every other cube drops nothing
        if sum(drops) > (0.02 * nch * n_c if "S=32" in label else 0):
            raise AssertionError(f"{label} dropped {sum(drops)}")
        if max(errs) > IMAGE_TOL:
            raise AssertionError(f"{label} parity failed: {max(errs)}")
        if label != "aw_idg_cube S=64":
            peak_at_source(res.image.cpu().numpy(), obs_c["sources"],
                           f"{label} continuum")
        results[label] = res
        del ref, ref_c, cube

    # double precision: in float32 the two routes' uv scalings round
    # differently and move a few dozen records across a weighting cell
    # (2.9e-3 on this observation); the kernels still run in float32
    saved = os.environ.get("SKA_SDP_TPU_EXACT_WEIGHTS")
    os.environ["SKA_SDP_TPU_EXACT_WEIGHTS"] = "1"
    try:
        exact = sp.idg_cube(vd_c, subgrid=S, taper_beta=BETA,
                            precision="double", **kw)
    finally:
        if saved is None:
            del os.environ["SKA_SDP_TPU_EXACT_WEIGHTS"]
        else:
            os.environ["SKA_SDP_TPU_EXACT_WEIGHTS"] = saved
    for c in (0, nch - 1):
        one = ds.idg_image(vd_c._replace(
            vis=vd_c.vis_chan[:, c], frequency=float(vd_c.frequencies[c])),
            subgrid=S, taper_beta=BETA, precision="double", **kw)
        err = rel_l2(crop75(exact.cube[c].cpu().numpy()),
                     crop75(one.image.cpu().numpy()))
        print(f"  exact weights (double): idg_cube channel {c} vs idg_image "
              f"of that channel alone ({vd_c.frequencies[c] / 1e6:.3f} MHz):"
              f" rel-L2 {err:.3e} over the central 75% (bound {IMAGE_TOL})")
        if not err <= IMAGE_TOL:
            raise AssertionError(f"channel {c} physics check failed: {err}")
    del exact
    tracks = sp.aw_idg_cube(vd_c, cube_akerns(), subgrid=S,
                            taper_beta=BETA, **kw)
    print(f"  aw_idg_cube on this observation's Earth-rotation tracks (no "
          f"bound): dropped {int(tracks.dropped.sum())} of {nch * n_c} "
          f"channel-visibilities: their runs outgrow the reference's run "
          f"bound 8·npair + n/128 + 64, and the overflow is counted")
    del tracks

    # ---- 25. times ----------------------------------------------------------
    for label, (fn, _, _) in cubes.items():
        # the S=32 drops were reported once in phase 24
        with contextlib.redirect_stderr(io.StringIO()):
            t = timed_ms(torch, fn)
        print(f"time {label} end to end: {t:.3f} ms = "
              f"{nch * n_c / t / 1e3:.2f} M channel-vis/s [{card}]")

    def group_inputs(vd, res):
        return cube_group_inputs(torch, dev, vd, res.groups[0])

    def report(name, label, prep, kernel, ops, io, tc=None):
        t_k = timed_ms(torch, kernel)
        b_ms, b_by = bound(nch * ops, nch * io)
        pre = (f"multi prep {timed_ms(torch, prep):.3f} ms, " if prep
               else "")
        tc_txt = (f"; tensor-core bound {nch * tc[0]:.3f} ms ({tc[1]})"
                  if tc else "")
        print(f"time {label}: {pre}one channel's {name} {t_k:.3f} ms "
              f"({n_c / t_k / 1e3:.2f} M vis/s); bound for the {nch} "
              f"channels {b_ms:.3f} ms ({b_by}{tc_txt}) against {nch} x "
              f"{t_k:.3f} = {nch * t_k:.3f} ms [{card}]")

    for label, vd, res in (("idg_cube S=64", vd_c, results["idg_cube S=64"]),
                           ("aw_idg_cube S=64", vd_aw,
                            results["aw_idg_cube S=64"])):
        prep, r0, scr = cube_channel_prep(
            torch, dev, vd, res.groups[0],
            ak if label.startswith("aw") else None)
        base, vis_s, *runs, nd0, _ = prep()
        recs, _ = awr.idg_aw_records_for_channel(base, vis_s[0], r0,
                                                 subgrid=S)
        n_live = int(base[5].sum())
        n_runs, longest, mean = run_stats(runs[0], runs[1])
        io_b = nbytes(recs, *runs, scr) + (n + 2 * S) ** 2 * 8
        _, tc_b = idg_stream_bounds(S, n_live, n_runs, io_b)
        report("idg_grid", f"{label} ({n_runs} runs, {n_live} records in "
               f"runs, longest {longest}, mean {mean:.1f})", prep,
               lambda: stream.idg_aw_grid_from_records_stream(
                   recs, *runs, (n, n), scr, theta=THETA, subgrid=S,
                   taper_beta=BETA),
               8 * S * S * n_live + (sandwich_flop(S)[0] + 12 * S * S)
               * n_runs, io_b, tc_b[:2])

    uvw1, vis1, r0, _ = group_inputs(vd_c, results["idg_cube S=32"])

    def prep32():
        return idg_tile.idg_bin_records_multi(
            (n, n), uvw1 / LAM, uvw1[:, 2], vis1.real, vis1.imag,
            subgrid=32, support=SUPPORT)

    base, vis_s, starts = prep32()
    recs, _ = idg_tile.idg_records_for_channel(base, vis_s[0], r0,
                                               subgrid=32)
    n_occ = int((starts[1:] > starts[:-1]).sum())
    HP, WP = idg_tile.tile_geometry((n, n), 32).padded_shape
    report("idg_tile_grid", f"idg_cube S=32 ({n_occ} subgrids)", prep32,
           lambda: idg_tile.idg_grid_from_records(
               recs, starts, (n, n), theta=THETA, subgrid=32,
               taper_beta=BETA),
           8 * 32 * 32 * int(starts[-1]) + sandwich_flop(32)[0] * n_occ,
           nbytes(recs, starts) + HP * WP * 8)

    uvw1, vis1, _, _ = group_inputs(vd_c, results["w_cube"])
    bank_c = torch.conj(bank.to(torch.complex64)).resolve_conj()
    cent = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    r0 = float(vd_c.frequencies[0] / results["w_cube"].groups[0][2])
    p0, w0 = uvw1 * r0 / LAM, uvw1[:, 2] * r0
    wbin = find_closest(cent, w0)
    nw, qpx, _, gh, gw = bank_c.shape
    y0, x0, _, valid = wproj.wproj_records((n, n), qpx, gh, gw,
                                           nw * qpx * qpx, p0, wbin)
    rows = torch.clamp(y0 + gh, max=n) - torch.clamp(y0, min=0)
    cols = torch.clamp(x0 + gw, max=n) - torch.clamp(x0, min=0)
    taps = int((rows.clamp(min=0) * cols.clamp(min=0))[valid].sum())
    report("wproj_grid", "w_cube (no prep: a plane search per channel)",
           None,
           lambda: wproj.wproj_gridder(bank_c, (n, n), p0, wbin, vis1[0],
                                       chunk=8192),
           8 * taps, nbytes(bank_c, p0, wbin, vis1[0]) + n * n * 8)


if __name__ == "__main__":
    sys.exit(main())
