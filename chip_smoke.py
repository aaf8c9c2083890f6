#!/usr/bin/env python3
"""Chip smoke test of ska_sdp_tpu_torch: the ported imaging, prediction and
spectral-cube paths, the PSF-normalised imaging, the staged,
checkpointed and streamed run surfaces and the sharded steps of the
scale-out (at world size 1) end to end on one NVIDIA GPU,
through the hand-written CUDA kernels (the streamed IDG gridder and
degridder, which also serve the fixed-tile IDG route and IDG-AW at every
even subgrid, the bank w-projection scatter, which also serves ``--mode
conv`` and ``wcache`` and every slab of a checkpointed or streamed run,
and gather, the fused AW gridder).

    python3 chip_smoke.py [--crowded | --synth]

Phases (each failure raises; the script then exits non-zero and prints no
result line):

1. device: a CUDA card is required (no CPU fallback); versions and the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build: compile ``ska_sdp_tpu_torch/csrc/idg_grid.cu``,
   ``csrc/idg_degrid.cu``, ``csrc/wproj_grid.cu``, ``csrc/wproj_degrid.cu``
   ``csrc/aw_grid.cu`` and ``csrc/wkernel_synth.cu`` with nvcc for sm_90a,
   one nvcc each, all started together; print the gridder's build time and
   the ptxas resource use of its S = 32, 64 and 128 instances;
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
6. build: the degridder's build time and the ptxas resource use of its
   S = 32, 64 and 128 instances;
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
    ``ops/wkernel`` (in float64, through ``csrc/wkernel_synth.cu``), each
    with the launch counts reset just before:
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
19. build: the ptxas resource use of the streamed kernels' instances for
    the other even subgrids (side 16·⌈S/16⌉), which the fixed-tile route
    at S ≠ 32, 64, 128 reaches, beside the two builds' times;
20. fixed-tile route parity on the card: ``idg_tile.idg_grid_from_records``
    and ``idg_degrid_from_records`` (the occupied subgrids as runs of the
    streamed kernels, ``tile_runs``) against the streamed plain versions on
    the same run table: 512² (θ=0.008) at S=16 (support 7), 32, 48 and 128
    (support 15), 200,000 random records with |p| ≤ 0.53 and |w| ≤ 100,000
    λ and a random grid, and the main path's 1,046,528 records at S=32
    (phase 4's weighted mirrored visibilities; phase 8's model grid); grid
    and visibility rel-L2 ≤ 5e-5, off-grid records predicting 0, and one
    launch of each streamed kernel through the route;
21. the S=32 main paths on phase 4's observation, each with the launch
    counts reset just before: ``idg_image(subgrid=32)`` (the fixed-tile
    route launched the streamed gridder, every streamed launch through
    it; phase 4's image checks, rel-L2 ≤ 1e-4 over the central 75%
    against the pipeline on the route's plain gridder; printed without a
    bound, against phase 4's S=64 image), ``idg_predict_vis(subgrid=32)``
    of phase 8's model (the route launched the streamed degridder; rel-L2
    ≤ 5e-5 against the route's plain degridder and ≤ 3e-4, the
    reference's S=32 bound, against phase 8's direct DFT), and the
    stage-timed ``runs.idg_staged`` at S=64 in memory (image within 1e-4 of
    phase 4's over the central 75%, the route launched the streamed
    gridder, the four stage times);
22. fixed-tile route times (CUDA events, median of 7 after a warm-up) at
    S=32 on the main path: each wrapper (run table, kernel and, for the
    degridder, its window sandwiches) and its plain version, the run table
    alone, the preps, and ``idg_image`` and ``idg_predict_vis`` end to
    end; the streamed kernels' bounds for the route's records and runs;
23. spectral kernel parity on the card (the fold evidence for the
    run-major #5): phase 3a's 512² IDG-AW records with random screens and
    4 channels of random visibilities at r ∈ {0.97, 0.99, 1.01, 1.03},
    through the multi prep and each channel's update, every channel's
    records through ``idg_grid.cu`` and its plain version (drift 7: nothing
    masked; drift 0: records masked and counted), and the fixed-tile multi
    prep at S=32 through the route onto ``idg_grid.cu``; grid rel-L2 ≤
    5e-5;
24. the cube main paths at full width on bench cell 8's observation (64
    stations, 520 times, 8 channels, seed 6: 1,048,320 records, 8,386,560
    channel-visibilities, 2400²), each with the launch counts reset just
    before: ``idg_cube`` at S=64 (one group, the streamed branch) and at
    S=32 (the fixed-tile branch: the route's launches of the streamed
    gridder), ``w_cube`` with phase 13's kind of bank,
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
    streamed gridder's tensor-core bound beside it);
26. IDG-AW at S=48 (the kernels' SP=48 instance, an odd multiple of 16) on
    phase 4's observation with phase 17's near-delta A-kernels of its 512
    stations as per-antenna screens: the streamed gridder and degridder on
    the main path's records (phase 8's model for the degridder) against
    their plain versions, rel-L2 ≤ 5e-5; ``aw_idg_image(subgrid=48)`` and
    ``aw_predict_vis(subgrid=48)``, each with the launch counts reset just
    before, against the same entries on the plain versions (image rel-L2 ≤
    1e-4 over the central 75%, predictions ≤ 5e-5), no drops, at least one
    launch of each kernel, the image's peak at a source; printed without a
    bound, the image against phase 4's S=64 image; the kernels' and the
    entries' times and the kernels' bounds;
27. the PSF-normalised imaging (``models.dataset.psf_image``: the
    reference CLI's ``--mode simple``, ``conv`` and ``wcache`` through
    ``do_imaging``, default ``wstep``) on phase 4's observation, each with
    the launch counts reset just before: a finite image and PSF, the PSF's
    peak 1 after the normalisation; ``simple`` runs no hand-written kernel
    (no scatter or synthesis launch) and has its peak at a source; ``conv``
    and ``wcache`` launch the bank scatter twice (image and PSF), each
    launch within 5e-5 of the plain scatter on its inputs, and the w-kernel
    synthesis (``csrc/wkernel_synth.cu``) once (``conv``) or twice
    (``wcache``), each launch within 2e-6 of its plain version on its
    screens; the image and PSF within 1e-4 of the same entry on the plain
    scatter and synthesis; the bank's plane count, the scatter's and the
    synthesis's times on the image's inputs beside their plain versions
    and bounds (the synthesis also beside pad + cuFFT), and each mode's
    time end to end.  The ``kernels`` line's synthesis entries take their
    launches from these calls;
28. the staged drivers of ``--device-phases`` in memory on phase 4's
    observation (``runs.wproj_staged`` and ``runs.aw_fused_staged`` with phase
    13's bank and phase 17's A-kernels, ``runs.aw_idg_staged`` at S=64 with
    the 512 stations' near-delta screens), each with the launch counts
    reset just before: every stage's time beside the dispatch floor, at
    least one launch of the stage's kernel, the image within 1e-5 rel-L2
    of the unstaged entry on the card (IDG-AW over the central 75%, with
    equal ``n_dropped``), and the kernel's last launch against its plain
    version on the same inputs (≤ 5e-5), both timed, with its bound;
29. the checkpointed slab loop (``w_image_slabs``) in slabs of 262,144
    (4 slabs), stopped after 2 and resumed from the host copy its
    callback made: 4 scatter launches, the image within 1e-5 of
    ``w_image``; each slab's scatter time, each host copy's time and
    bytes (into ``HostCopy``'s page-locked buffer, as the checkpoint
    writer copies); a slab's scatter (onto the running grid) against the
    plain scatter; the grid's page-locked and pageable copies; the loop's
    time with a host copy a slab at 4 slabs (and with pageable copies)
    and at the default slab (one) against ``w_image``'s;
30. the streamed two-pass loop (``w_image_streamed``) over numpy readers
    of the same observation in slabs of 262,144: the pass-1 histogram on
    the card equal to a float64 numpy histogram integer for integer, 4
    scatter launches, the image within 1e-5 of the same loop on the plain
    scatter on the card; printed without a bound, its rel-L2 against
    ``w_image`` (other weights); a slab's scatter against the plain
    scatter; the histogram pass's, the loop's and the prefetch wait's
    times;
31. the scale-out (``ska_sdp_tpu_torch.parallel``) at world size 1 on
    NCCL (one card: NCCL puts no two ranks on one GPU; the process group
    exists only for phases 31-35): ``make_sharded_wproj_step``,
    ``_gridfft`` (the pencil FFT) and ``_gridscatter`` (reduce-scatter,
    the row-sharded Hermitian, the pencil FFT) on phase 4's observation
    with phase 13's kind of bank, each with the launch counts reset just
    before: one scatter launch a step, the image within 1e-4 of
    ``w_image``; the first step's scatter against the plain scatter;
32. ``make_sharded_idg_step`` at S=64 and S=32 (the fixed-tile route):
    one gridder launch each, the image within 1e-4 over the central 75%
    of the same chain unsharded on the card (weights, mirroring,
    ``kernels.idg_gridder``, Hermitian, inverse FFT, taper);
33. ``make_sharded_predict_step`` of phase 8's model: one gather launch,
    within 5e-5 of ``w_predict_vis``; its gather against the plain gather;
34. ``make_sharded_idg_aw_step`` on phase 9's IDG-AW track shape with the
    run bound of ``aw_idg_image`` from the rank's shard: 0 dropped, one
    gridder launch, the image within 1e-4 over the central 75% of the
    same chain on one device; its gridder against the plain gridder;
35. ``models.spectral.idg_cube_sharded`` (the in-memory core of
    ``idg_gridding_multi_sharded``) on phase 24's cube observation: one
    gridder launch a channel, each channel within 1e-4 over the central
    75% of the same core on the plain kernels on the card; printed
    without a bound, its distance from ``idg_cube`` (exact per-channel
    coordinates against binning shared across a group).

36. low precision (``ops/lowprec.py``): all 65,536 posit16 patterns
    decoded on the card and encoded back (the identity), a seeded sample
    of 4,194,304 float32s (the posit range and beyond, zeros, subnormals,
    ±inf, NaNs, raw bit patterns) encoded, and the four quantizers
    (posit16, bf16, f8 e4m3 with its overflow to NaN, f8 e5m2) on it as
    complex64, each equal to the plain version on the CPU bit for bit;
    ``gridding_quantization_error`` at the bank benchmark's shape (phase
    12's 1,048,576 records, NW=32, QPX=8, 15², 2400²) with the launch
    counts reset just before: five scatter launches (the reference grid
    and one a format), the four errors and the study's time; each
    quantized grid against the plain scatter on the same quantized inputs,
    rel-L2 ≤ 5e-5;
37. cross-method (the scatters fed with ``ops.idg.tapered_w_bank``, the
    exact-scatter bank of IDG's operator): IDG (``kernels.idg_gridder``,
    S=64) on phase 4's observation with the uv snapped to the qpx=8
    lattice and w at its bank plane, against the bank scatter on the
    tapered bank of phase 13's 32 planes; IDG-AW (``kernels.
    idg_aw_gridder``, S=64) on phase 9's track shape with near-delta
    A-kernels (unit centres, 5% noise on the central 3×3: the AW scatter
    truncates (a1 ⊛ a2) ⊛ w to 15 taps), against the AW scatter fed with
    the conjugated tapered bank; each pair of taper-corrected images
    within 3e-4 (rel-L2, central 75%; the reference tests' bound), 0
    dropped, one launch of each kernel a pair; each kernel against its
    plain version;
38. HDF5 on the card: ``io/native/build.find_hdf5`` looks for an HDF5 1.10
    runtime.  With none, one line says so, naming the sonames and
    directories searched, and the phase ends.  With one: the native
    library is built, phase 4's observation is written with
    ``io/synthetic.write_vis_file`` through the native backend, the CLI's
    ``--mode idg`` file entry runs on the card (``cli.main`` with ``-o``
    and ``-dphases``, the launch counts reset just before, its read,
    compute and write phase times printed) and ``/img`` is read back:
    within 1e-5 (rel-L2, central 75%) of ``idg_image`` on the same arrays;
    its gridder against the plain gridder.  A build, read or write failure
    fails the run;
39. the crowded SKA1-Low core (``python3 chip_smoke.py --crowded`` runs
    it alone, after building the two IDG kernels): the benchmark cell
    ``idg.cycle``'s own run tables at 3888² (``benchmark/observation.py``,
    seed 0, sky 0, through ``idg_image``'s and ``idg_predict_vis``'s
    preps), its longest run and the share of the records the longest 1, 5
    and 20 runs hold; #1 and #2 alone, each timed with CUDA events (median
    of 7), within 5e-5 of its plain version, with its work items (item
    length, items, runs split) and the split counts the kernel made equal
    to those of the plain items (``run_items``);
40. w-kernel synthesis (``python3 chip_smoke.py --synth`` runs it alone,
    after building its kernel): ``csrc/wkernel_synth.cu`` on the benchmark
    cell ``wcache.psf``'s bank (33 planes over ±1,920 λ, θ = 0.054, a 256²
    screen, qpx 8, support 15) in complex64 and complex128, against
    ``ops.wkernel.w_kernel_taps_plain`` and against the padded transform
    (pad, centred cuFFT, extract) on the card, rel-L2 ≤ 2e-6 (complex64)
    and ≤ 1e-12 (complex128) each, the conjugated taps equal to the taps'
    conjugate; each timed with CUDA events (median of 7): the kernel, the
    plain version and the padded transform (``library_ms``), beside the
    bound (operations over 67 TFLOP/s, bytes over 3.35 TB/s) and the
    kernel's launches, printed only.

Each of phases 31-35 prints its wall time (median of 3 synchronised
calls), its launches, the time of one ``all_reduce`` of the
46,080,000-byte 2400² grid, and the card's name and power limit.

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
import re
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
TRUTH_TOL_S32 = 3e-4     # the same at S=32 (the reference's S=32 bound)
C = 299792458.0
REPS = 7
SLAB = 262_144           # phases 29-30: 4 slabs of the main path
STAGED_TOL = 1e-5        # staged and slab-wise images against one-shot
CROSS_TOL = 3e-4         # IDG(-AW) against the scatters on the tapered bank
FILE_TOL = 1e-5          # the file entry's image against idg_image


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


def print_ptxas(build_log, name, padded=None):
    """The compiler's register and spill lines of ``name``'s kernels, each
    under its entry's name (``<SP, kPad>`` for the streamed IDG kernels'
    instances); ``padded`` keeps only the instances with that kPad."""
    keep = True
    for line in build_log.get(name, "").splitlines():
        if "Compiling entry function" in line:
            sym = line.split("'")[1]
            m = re.search(r"(idg_(?:de)?grid_kernel)ILi(\d+)ELb(\d)E", sym)
            keep = padded is None or (
                m.group(3) == str(int(padded)) if m else not padded)
            if keep:
                k = re.search(r"\d([a-z][a-z_]*_kernel|[A-Z][a-z]\w*?Kernel)",
                              sym)
                label = (f"{m.group(1)}<{m.group(2)}, "
                         f"{'true' if m.group(3) == '1' else 'false'}>"
                         if m else k.group(1) if k else sym[:60])
                print(f"  ptxas: {label}")
        elif keep and ("registers" in line or "spill" in line):
            print(f"    {line.strip()}")


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


# ---- the main paths' inputs ------------------------------------------------
def main_observation():
    """Phase 4's synthetic SKA1-Low observation: ``(obs dict, VisData)``."""
    from ska_sdp_tpu_torch.io.synthetic import (SyntheticConfig,
                                                simulate_observation)
    from ska_sdp_tpu_torch.io.inputs import vis_data_from_observation

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

    from ska_sdp_tpu_torch.io.inputs import VisData

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
    from ska_sdp_tpu_torch.io.inputs import vis_data_from_observation

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
    from ska_sdp_tpu_torch.io.inputs import VisData

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
    uvw1, vis1 = sp.group_inputs(uvw, f_ref, rat, vis, theta=THETA,
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
        layout = ds.detect_time_major_layout(vd.antenna1, vd.antenna2,
                                             vd.time, n_c)
        a1, a2 = (sp._pair_major(torch.as_tensor(a.astype(np.int32),
                                                 device=dev), layout)
                  for a in (vd.antenna1, vd.antenna2))
        uvw1 = sp._pair_major(uvw1, layout)
        vis1 = sp._pair_major(vis1, layout, axis=1)
        scr = ds.antenna_screens(ak, S, THETA, LAM, None, SINGLE, dev)
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
    from ska_sdp_tpu_torch.io.inputs import vis_data_from_observation
    from ska_sdp_tpu_torch.models.dataset import (idg_finish, idg_grid_inputs,
                                                  idg_image, idg_inputs)
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
                  "aw_grid", "wkernel_synth")
    pool = ThreadPoolExecutor(max_workers=len(kernels_cu))
    builds = {k: pool.submit(build, k) for k in kernels_cu}
    pool.shutdown(wait=False)
    print(f"build: idg_grid.cu for sm_90a in "
          f"{builds['idg_grid'].result():.1f} s")
    print_ptxas(_build.build_log, "idg_grid", padded=False)

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
    img_plain = idg_finish(pl_full, g.n, g.grid_shape[0], g.crop_lo,
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
    print_ptxas(_build.build_log, "idg_degrid", padded=False)
    degrid, model, truth = degrid_phases(torch, dev, card, mid, vd, obs,
                                         k_full)
    for k in ("wproj_grid", "wproj_degrid", "wkernel_synth"):
        print(f"build: {k}.cu for sm_90a in {builds[k].result():.1f} s "
              "(started with idg_grid.cu)")
        print_ptxas(_build.build_log, k)
    wproj, img_w = wproj_phases(torch, dev, card, vd, obs, img, model,
                                truth)
    print(f"build: aw_grid.cu for sm_90a in "
          f"{builds['aw_grid'].result():.1f} s (started with idg_grid.cu)")
    print_ptxas(_build.build_log, "aw_grid")
    aw = aw_phases(torch, dev, card, vd, obs, img_w)
    for k in ("idg_grid", "idg_degrid"):
        print(f"build: {k}.cu's instances for the other even subgrids "
              f"(side 16·⌈S/16⌉), in its {builds[k].result():.1f} s")
        print_ptxas(_build.build_log, k, padded=True)
    tile = tile_phases(torch, dev, card, vd, obs, img, model, truth)
    spectral_phases(torch, dev, card, mid)
    aw48 = aw48_phases(torch, dev, card, vd, obs, img, model)
    psf = psf_phases(torch, dev, card, vd, obs)
    runs = run_surface_phases(torch, dev, card, vd, obs)
    scale = scaleout_phases(torch, dev, card, vd, obs, model)
    edges = edge_phases(torch, dev, card, vd, obs)
    crowded_phase(torch, dev, card)
    synth_phase(torch, dev, card)

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
    }, *wproj, aw, *tile, *aw48, *psf, *runs, *scale, *edges]}))
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
    mr = ds.aw_run_bound(vd_aw.antenna1, vd_aw.antenna2, nT)
    layout = ds.detect_time_major_layout(vd_aw.antenna1, vd_aw.antenna2,
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
    scr = ds.antenna_screens(ak, SUBGRID, THETA, LAM, None, SINGLE, dev)
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
    img_plain = ds.idg_finish(guv, n, n, 0, SUBGRID, BETA).cpu().numpy()
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
    print(f"time bank build (32 planes, 256² screens through "
          f"wkernel_synth.cu, float64): {timed_ms(torch, build_bank):.3f} ms "
          f"[{card}]")

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


def tile_route_plain(torch, recs, starts, shape, S, *, theta, order=None,
                     grid=None):
    """The fixed-tile route's plain version on the records' device: the
    run table of ``idg_tile.tile_runs`` through the streamed plain gridder
    (cropped as the wrapper crops it) or, with ``order`` and ``grid``, the
    streamed plain degridder."""
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.kernels import idg_tile

    r = idg_tile.tile_runs(starts, shape, S)
    unit = torch.ones((1, S, S), dtype=torch.complex64, device=recs.device)
    kw = dict(theta=theta, subgrid=S, taper_beta=BETA)
    if grid is None:
        g = stream.grid_from_records_plain(
            recs, r.starts_ext[:-1], r.starts_ext[1:], r.y0, r.x0, r.pair,
            r.pair, unit, grid_shape=shape, **kw)
        return g[S:S + shape[0], S:S + shape[1]]
    return stream.degrid_from_records_plain(
        recs, r.starts_ext, r.y0, r.x0, r.pair, r.pair, order, grid, unit,
        **kw)


def route_launches(stream, idg_tile, which):
    """``(fixed-tile route launches, streamed launches)`` of the gridder
    (``which="grid"``) or degridder since the last resets."""
    g = which == "grid"
    return (idg_tile.launch_count(idg_tile.GRID_KERNEL if g
                                  else idg_tile.DEGRID_KERNEL),
            stream.launch_count(stream.GRID_KERNEL if g
                                else stream.DEGRID_KERNEL))


def tile_phases(torch, dev, card, vd, obs, img64, model, truth):
    """Phases 20-22.  ``vd``/``obs`` are the main path's observation,
    ``img64`` phase 4's S=64 ``idg_image``, ``model`` and ``truth`` phase
    8's snapped-source model and its float64 direct-DFT visibilities.
    Returns the fixed-tile route's two entries of the ``kernels`` line."""
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.kernels import idg_tile
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.models import runs
    from ska_sdp_tpu_torch.utils.timing import PhaseTimer

    S32 = 32
    kw32 = dict(subgrid=S32, taper_beta=BETA)

    def reset():
        stream.reset_launch_count()
        idg_tile.reset_launch_count()

    def parity(label, shape, S, support, theta, g_in, d_in):
        p, w, vis = g_in
        recs, starts = idg_tile.idg_bin_records(
            shape, p, w, vis.real, vis.imag, subgrid=S, support=support)
        kw = dict(theta=theta, subgrid=S, taper_beta=BETA)
        reset()
        gk = idg_tile.idg_grid_from_records(recs, starts, shape, **kw)
        torch.cuda.synchronize()
        lg = route_launches(stream, idg_tile, "grid")
        gp_t = tile_route_plain(torch, recs, starts, shape, S, theta=theta)
        dp, dw, grid = d_in
        drecs, dstarts, order, valid = idg_tile.prep_with_order(
            shape, dp, dw, subgrid=S, support=support)
        reset()
        vk = idg_tile.idg_degrid_from_records(drecs, dstarts, order, grid,
                                              **kw)
        torch.cuda.synchronize()
        ld = route_launches(stream, idg_tile, "degrid")
        vp = tile_route_plain(torch, drecs, dstarts, shape, S, theta=theta,
                              order=order, grid=grid)
        gk, gp, vk, vp = (x.cpu().numpy() for x in (gk, gp_t, vk, vp))
        err_g, err_v = rel_l2(gk, gp), rel_l2(vk, vp)
        valid = valid.cpu().numpy()
        n_occ = int((starts[1:] > starts[:-1]).sum())
        print(f"tile parity {label}: grid rel-L2 {err_g:.3e}, vis rel-L2 "
              f"{err_v:.3e} (bound {KERNEL_TOL}); {int(valid.sum())} of "
              f"{valid.shape[0]} records on the grid, {n_occ} of "
              f"{starts.shape[0] - 1} subgrids occupied (the runs); "
              f"nonzero predictions kernel {int((vk != 0).sum())} plain "
              f"{int((vp != 0).sum())}; launches (route, streamed) grid "
              f"{lg}, degrid {ld}")
        if not (err_g <= KERNEL_TOL and err_v <= KERNEL_TOL):
            raise AssertionError(f"tile parity {label} failed: {err_g}, "
                                 f"{err_v}")
        if np.any(vk[~valid] != 0) or np.any(vp[~valid] != 0):
            raise AssertionError(f"tile parity {label}: off-grid records "
                                 "predicted nonzero")
        if lg != (1, 1) or ld != (1, 1):
            raise AssertionError(f"tile parity {label}: the route did not "
                                 f"launch the streamed kernels once: {lg}, "
                                 f"{ld}")
        return dict(recs=recs, starts=starts, drecs=(drecs, dstarts, order),
                    gp=gp_t, vp=vp, max_abs_g=float(np.abs(gk - gp).max()),
                    max_abs_v=float(np.abs(vk - vp).max()), n_occ=n_occ,
                    n_docc=int((dstarts[1:] > dstarts[:-1]).sum()))

    # ---- 20a. 512² at S = 16, 32, 48, 128, records beyond the edges ------
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
    reset()
    res = ds.idg_image(vd, theta=THETA, lam=LAM, device=dev, **kw32)
    torch.cuda.synchronize()
    launches_g, launches_stream = route_launches(stream, idg_tile, "grid")
    img = res.image.cpu().numpy()
    n = img.shape[0]
    print(f"S=32 main path: idg_image {n}² from {n_vis} vis, image max "
          f"{res.image_max:.6g}, n_dropped {res.n_dropped}, fixed-tile "
          f"route launches {launches_g}, streamed gridder launches "
          f"{launches_stream}")
    if not np.isfinite(img).all():
        raise AssertionError("S=32 image has non-finite pixels")
    if res.n_dropped != 0:
        raise AssertionError(f"S=32 imaging dropped {res.n_dropped}")
    if launches_g < 1 or launches_stream != launches_g:
        raise AssertionError("idg_image(subgrid=32) did not launch the "
                             "streamed gridder through the fixed-tile route")
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
    img_plain = ds.idg_finish(main["gp"], g.n, shape[0], g.crop_lo, S32,
                              BETA).cpu().numpy()
    err_img = rel_l2(crop75(img), crop75(img_plain))
    print(f"  image vs the route's plain pipeline: rel-L2 {err_img:.3e} "
          f"over the central 75% (bound {IMAGE_TOL}); vs phase 4's S=64 "
          f"image (no bound): {rel_l2(crop75(img), crop75(img64)):.3e}")
    if not err_img <= IMAGE_TOL:
        raise AssertionError(f"S=32 image parity failed: {err_img}")

    # ---- 21b. idg_predict_vis at S=32 --------------------------------------
    reset()
    pred = ds.idg_predict_vis(vd, model, theta=THETA, lam=LAM, device=dev,
                              **kw32)
    torch.cuda.synchronize()
    launches_d, launches_stream = route_launches(stream, idg_tile, "degrid")
    err_pred = rel_l2(pred.vis.cpu().numpy(), main["vp"])
    got = pred.vis.to(torch.complex128)
    err_truth = float(torch.linalg.norm(got - truth)
                      / torch.linalg.norm(truth))
    print(f"S=32 predict main path: idg_predict_vis of phase 8's model to "
          f"{n_vis} vis, peak |vis| {pred.peak:.6g}, n_dropped "
          f"{pred.n_dropped}, fixed-tile route launches {launches_d}, "
          f"streamed degridder launches {launches_stream}; vs the route's "
          f"plain degridder rel-L2 {err_pred:.3e} (bound {KERNEL_TOL}); vs "
          f"float64 direct DFT {err_truth:.3e} (bound {TRUTH_TOL_S32}, the "
          "reference's S=32 bound)")
    if not torch.isfinite(pred.vis).all():
        raise AssertionError("S=32 prediction has non-finite values")
    if pred.n_dropped != 0:
        raise AssertionError(f"S=32 predict dropped {pred.n_dropped}")
    if launches_d < 1 or launches_stream != launches_d:
        raise AssertionError("idg_predict_vis(subgrid=32) did not launch "
                             "the streamed degridder through the fixed-tile "
                             "route")
    if not err_pred <= KERNEL_TOL:
        raise AssertionError(f"S=32 predict parity failed: {err_pred}")
    if not err_truth <= TRUTH_TOL_S32:
        raise AssertionError(f"S=32 predict vs direct DFT: {err_truth}")

    # ---- 21c. the stage-timed pipeline at S=64 -----------------------------
    timer = PhaseTimer()
    reset()
    img_st, _ = runs.idg_staged(uvw, f, vis, theta=THETA, lam=LAM,
                                subgrid=SUBGRID, taper_beta=BETA, timer=timer)
    torch.cuda.synchronize()
    launches_st, launches_sst = route_launches(stream, idg_tile, "grid")
    err_st = rel_l2(crop75(img_st.cpu().numpy()), crop75(img64))
    stages = ", ".join(f"{k[7:]} {v * 1e3:.3f} ms"
                       for k, v in timer.times.items()
                       if k.startswith("device/") and "+compile" not in k)
    print(f"staged S=64 (idg_staged, in memory): vs phase 4's idg_image "
          f"rel-L2 {err_st:.3e} over the central 75% (bound {IMAGE_TOL}), "
          f"fixed-tile route launches {launches_st}, streamed "
          f"{launches_sst} (warm-up + timed); stages: {stages} [{card}]")
    if launches_st < 1 or launches_sst != launches_st:
        raise AssertionError("idg_staged did not launch the streamed "
                             "gridder through the fixed-tile route")
    if not err_st <= IMAGE_TOL:
        raise AssertionError(f"staged image parity failed: {err_st}")

    # ---- 22. times at S=32 on the main path --------------------------------
    recs, starts = main["recs"], main["starts"]
    drecs, dstarts, order = main["drecs"]
    it = idg_tile
    ms = {}
    for label, fn in (
            ("gridder (route + CUDA)", lambda: it.idg_grid_from_records(
                recs, starts, shape, theta=g.theta, **kw32)),
            ("gridder plain (PyTorch)", lambda: tile_route_plain(
                torch, recs, starts, shape, S32, theta=g.theta)),
            ("degridder (route + CUDA, window sandwiches included)",
             lambda: it.idg_degrid_from_records(
                 drecs, dstarts, order, d.grid, theta=d.theta, **kw32)),
            ("degridder plain (PyTorch)", lambda: tile_route_plain(
                torch, drecs, dstarts, shape, S32, theta=d.theta,
                order=order, grid=d.grid)),
            ("run table (tile_runs)", lambda: it.tile_runs(
                starts, shape, S32)),
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

    # bounds from this run's inputs, as the streamed kernels' (their
    # function, with unit screens): per record 8·S², per run (occupied
    # subgrid) the sandwich and the screens; the gridder reads its records
    # and starts and writes the S-padded grid, the degridder reads its
    # records, starts, order and the model grid and writes the visibilities
    n_in, n_din = int(starts[-1]), int(dstarts[-1])
    g_io = nbytes(recs, starts) + (shape[0] + 2 * S32) ** 2 * 8
    d_io = nbytes(drecs, dstarts, order, d.grid) + n_vis * 8
    bounds = {}
    for label, n_rec, n_run, io_b in (
            ("gridder", n_in, main["n_occ"], g_io),
            ("degridder", n_din, main["n_docc"], d_io)):
        (f_ms, f_by), (b_ms, b_by, t_tc, t_cuda) = idg_stream_bounds(
            S32, n_rec, n_run, io_b)
        bounds[label] = (b_ms, b_by)
        t = ms[next(k for k in ms if k.startswith(label + " (route"))]
        print(f"tile {label} bounds at S=32 ({n_rec} records in {n_run} "
              f"runs): f32 {f_ms:.3f} ms ({f_by}); tensor core {b_ms:.3f} "
              f"ms ({b_by}: split3 products {t_tc:.3f} ms, phase factors, "
              f"screens and sandwiches on the CUDA cores {t_cuda:.3f} ms, "
              f"bytes {io_b / HBM_BPS * 1e3:.3f} ms); the route at "
              f"{100 * b_ms / t:.1f}% of it")
    return [{
        "name": idg_tile.GRID_KERNEL, "route": "cuda",
        "source": "ska_sdp_tpu_torch/csrc/idg_grid.cu",
        "replaces": "ska_sdp_tpu/kernels/idg_pallas.py:49",
        "launches": launches_g, "max_abs_err": main["max_abs_g"],
        "ms": ms["gridder (route + CUDA)"],
        "plain_ms": ms["gridder plain (PyTorch)"],
        "bound_ms": bounds["gridder"][0], "bound_by": bounds["gridder"][1],
        "library_ms": None,
    }, {
        "name": idg_tile.DEGRID_KERNEL, "route": "cuda",
        "source": "ska_sdp_tpu_torch/csrc/idg_degrid.cu",
        "replaces": "ska_sdp_tpu/kernels/idg_degrid_pallas.py:41",
        "launches": launches_d, "max_abs_err": main["max_abs_v"],
        "ms": ms["degridder (route + CUDA, window sandwiches included)"],
        "plain_ms": ms["degridder plain (PyTorch)"],
        "bound_ms": bounds["degridder"][0],
        "bound_by": bounds["degridder"][1], "library_ms": None,
    }]


@contextlib.contextmanager
def plain_kernels(torch):
    """Route the cube entries (``models/spectral.py``), the IDG-AW entries
    (``kernels.idg_aw_gridder`` and ``idg_aw_degridder``), the imaging
    functions of ``models/imaging.py`` and the w-kernel synthesis
    (``ops.wkernel.w_kernel`` on the card) through the plain versions of
    their kernels, on the tensors' own device."""
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.kernels import wkernel_synth as synth
    from ska_sdp_tpu_torch.models import imaging
    from ska_sdp_tpu_torch.models import spectral as sp
    from ska_sdp_tpu_torch.ops.gridding import convgrid_wproj
    from ska_sdp_tpu_torch.ops.wkernel import w_kernel_taps_plain

    def streamed(recs, st, en, y0, x0, i1, i2, shape, scr, *, theta,
                 subgrid, taper_beta):
        g = stream.grid_from_records_plain(
            recs, st, en, y0, x0, i1, i2, scr, grid_shape=shape, theta=theta,
            subgrid=subgrid, taper_beta=taper_beta)
        return g[subgrid:subgrid + shape[0], subgrid:subgrid + shape[1]]

    def tile(recs, starts, shape, *, theta, subgrid, taper_beta):
        return tile_route_plain(torch, recs, starts, shape, subgrid,
                                theta=theta)

    def scatter(bank_conj, shape, p, wbin, vis, chunk):
        return convgrid_wproj(bank_conj, torch.zeros(
            shape, dtype=vis.dtype, device=vis.device), p, wbin, vis,
            chunk=chunk)

    def degrid(recs, starts_ext, y0, x0, ia1, ia2, order_s, grid, scr, *,
               theta, subgrid, taper_beta):
        return stream.degrid_from_records_plain(
            recs, starts_ext, y0, x0, ia1, ia2, order_s, grid, scr,
            theta=theta, subgrid=subgrid, taper_beta=taper_beta)

    patches = ((sp, "idg_aw_grid_from_records_stream", streamed),
               (sp, "idg_grid_from_records", tile),
               (sp, "wproj_gridder", scatter),
               (stream, "idg_aw_grid_from_records_stream", streamed),
               (stream, "idg_aw_degrid_from_records_stream", degrid),
               (imaging, "wproj_gridder", scatter),
               (synth, "wkernel_synth", w_kernel_taps_plain))
    saved = [getattr(mod, k) for mod, k, _ in patches]
    for mod, k, fn in patches:
        setattr(mod, k, fn)
    try:
        yield
    finally:
        for (mod, k, _), fn in zip(patches, saved):
            setattr(mod, k, fn)


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
    stream.reset_launch_count()
    idg_tile.reset_launch_count()
    for c, r in enumerate(ratios):
        recs, nm = idg_tile.idg_records_for_channel(base, vis_s[c], r,
                                                    subgrid=32)
        k = idg_tile.idg_grid_from_records(recs, starts, shape, theta=THETA,
                                           subgrid=32, taper_beta=BETA)
        pl = tile_route_plain(torch, recs, starts, shape, 32, theta=THETA)
        errs.append(rel_l2(k.cpu().numpy(), pl.cpu().numpy()))
        masked.append(int(nm))
    launches = route_launches(stream, idg_tile, "grid")
    print(f"spectral parity, fixed-tile multi prep (512², S=32, "
          f"{int((starts[1:] > starts[:-1]).sum())} runs): the route on "
          f"idg_grid vs plain rel-L2 per channel "
          f"{', '.join(f'{e:.3e}' for e in errs)} (bound {KERNEL_TOL}); "
          f"n_masked per channel {masked}; launches (route, streamed) "
          f"{launches}")
    if max(errs) > KERNEL_TOL:
        raise AssertionError(f"fixed-tile spectral parity failed: {errs}")
    if launches != (len(ratios), len(ratios)):
        raise AssertionError(f"fixed-tile spectral launches {launches}")
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
    # each cube's launch counts: one a channel of its kernel, none of the
    # others; at S=32 the fixed-tile route launches the streamed gridder
    cubes = {
        "idg_cube S=64": (lambda: sp.idg_cube(vd_c, subgrid=S,
                                              taper_beta=BETA, **kw),
                          ("idg_grid",), True),
        "idg_cube S=32": (lambda: sp.idg_cube(vd_c, subgrid=32,
                                              taper_beta=BETA, **kw),
                          ("idg_tile_grid", "idg_grid"), True),
        "w_cube": (lambda: sp.w_cube(vd_c, bank, centers, **kw),
                   ("wproj_grid",), False),
        "aw_idg_cube S=64": (lambda: sp.aw_idg_cube(vd_aw, ak, subgrid=S,
                                                    taper_beta=BETA, **kw),
                             ("idg_grid",), True),
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
        if launches != {k: nch if k in kernel else 0 for k in counted}:
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
    n_in = int(starts[-1])
    io_t = nbytes(recs, starts) + (n + 64) ** 2 * 8
    _, tc_t = idg_stream_bounds(32, n_in, n_occ, io_t)
    report("idg_tile_grid", f"idg_cube S=32 ({n_occ} subgrids, the "
           "route on idg_grid)", prep32,
           lambda: idg_tile.idg_grid_from_records(
               recs, starts, (n, n), theta=THETA, subgrid=32,
               taper_beta=BETA),
           8 * 32 * 32 * n_in + (sandwich_flop(32)[0] + 12 * 32 * 32)
           * n_occ, io_t, tc_t[:2])

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


def aw48_phases(torch, dev, card, vd, obs, img64, model):
    """Phase 26: IDG-AW at S=48 (the kernels' SP=48 instance, an odd
    multiple of 16) on the main path.  ``vd``/``obs`` are the main path's
    observation, ``img64`` phase 4's S=64 ``idg_image`` and ``model``
    phase 8's snapped-source model.  Returns the gridder's and the
    degridder's entries of the ``kernels`` line."""
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.kernels.idg_aw_records import (
        idg_aw_degrid_records, idg_aw_run_records)
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.ops.idg_aw import PAIR_SHIFT
    from ska_sdp_tpu_torch.types import SINGLE

    S = 48
    n_vis = vd.vis.shape[0]
    ak = main_akerns()
    kw = dict(theta=THETA, lam=LAM, subgrid=S, taper_beta=BETA, device=dev)

    # ---- 26a. #1 and #2 at S=48 on the main path's records ----------------
    scr = ds.antenna_screens(ak, S, THETA, LAM, None, SINGLE, dev)
    uvw, f, vis = ds.idg_inputs(vd, device=dev)
    a1, a2 = (torch.as_tensor(a.astype(np.int32), device=dev)
              for a in (vd.antenna1, vd.antenna2))
    layout = ds.detect_time_major_layout(vd.antenna1, vd.antenna2, vd.time,
                                         n_vis)
    mr = ds.aw_run_bound(vd.antenna1, vd.antenna2, n_vis)
    ga, a1g, a2g = ds.aw_grid_inputs(uvw, a1, a2, f, vis, theta=THETA,
                                     lam=LAM, layout=layout)
    shape = ga.grid_shape
    kg = dict(theta=ga.theta, subgrid=S, taper_beta=BETA)
    recs = idg_aw_run_records(shape, ga.p, a1g, a2g, ga.w, ga.vis.real,
                              ga.vis.imag, subgrid=S, support=SUPPORT,
                              max_runs=mr, ordered=layout is not None,
                              nant=scr.shape[0])
    k = stream.idg_aw_grid_from_records_stream(*recs[:7], shape, scr, **kg)
    pl = stream.grid_from_records_plain(*recs[:7], scr, grid_shape=shape,
                                        **kg)[S:S + shape[0], S:S + shape[1]]
    kn, pn = k.cpu().numpy(), pl.cpu().numpy()
    err_g, max_abs_g = rel_l2(kn, pn), float(np.abs(kn - pn).max())
    n_runs, longest, mean = run_stats(recs[1], recs[2])
    d = ds.degrid_inputs(torch.as_tensor(model, device=dev), uvw, f,
                         theta=THETA, lam=LAM, subgrid=S, taper_beta=BETA)
    drecs = idg_aw_degrid_records(tuple(d.grid.shape), d.p, a1, a2, d.w,
                                  subgrid=S, support=SUPPORT, max_runs=mr)
    kd = stream.idg_aw_degrid_from_records_stream(*drecs[:7], d.grid, scr,
                                                  **kg)
    pd = stream.degrid_from_records_plain(*drecs[:7], d.grid, scr, **kg)
    kdn, pdn = kd.cpu().numpy(), pd.cpu().numpy()
    err_d, max_abs_d = rel_l2(kdn, pdn), float(np.abs(kdn - pdn).max())
    print(f"IDG-AW S=48 kernel parity ({shape[0]}², {n_vis} records of the "
          f"main path, {scr.shape[0]} per-antenna screens of near-delta "
          f"A-kernels, the SP=48 instance): grid rel-L2 {err_g:.3e} "
          f"({n_runs} runs, longest {longest}, mean {mean:.2f}), degrid of "
          f"phase 8's model rel-L2 {err_d:.3e} (bound {KERNEL_TOL}); "
          f"n_dropped prep grid {int(recs[7])} degrid {int(drecs[8])}")
    if not (err_g <= KERNEL_TOL and err_d <= KERNEL_TOL):
        raise AssertionError(f"S=48 kernel parity failed: {err_g}, {err_d}")

    # ---- 26b. aw_idg_image and aw_predict_vis at S=48 ----------------------
    stream.reset_launch_count()
    res = ds.aw_idg_image(vd, ak, **kw)
    torch.cuda.synchronize()
    launches_g = stream.launch_count(stream.GRID_KERNEL)
    with plain_kernels(torch):
        ref = ds.aw_idg_image(vd, ak, **kw)
    img, img_p = res.image.cpu().numpy(), ref.image.cpu().numpy()
    err_img = rel_l2(crop75(img), crop75(img_p))
    print(f"S=48 main path: aw_idg_image {img.shape[0]}² from {n_vis} vis, "
          f"image max {res.image_max:.6g}, n_dropped {res.n_dropped} "
          f"(expected 0), gridder launches {launches_g}; vs the same "
          f"pipeline on the plain versions rel-L2 {err_img:.3e} over the "
          f"central 75% (bound {IMAGE_TOL}); vs phase 4's S=64 IDG image "
          f"(no bound): {rel_l2(crop75(img), crop75(img64)):.3e}")
    if not np.isfinite(img).all():
        raise AssertionError("S=48 IDG-AW image has non-finite pixels")
    if res.n_dropped != 0 or ref.n_dropped != 0:
        raise AssertionError(f"S=48 IDG-AW imaging dropped {res.n_dropped}")
    if launches_g < 1:
        raise AssertionError("aw_idg_image(subgrid=48) did not launch the "
                             "streamed gridder")
    if not err_img <= IMAGE_TOL:
        raise AssertionError(f"S=48 IDG-AW image parity failed: {err_img}")
    peak_at_source(img, obs["sources"], "aw_idg_image S=48")

    stream.reset_launch_count()
    pred = ds.aw_predict_vis(vd, ak, model, **kw)
    torch.cuda.synchronize()
    launches_d = stream.launch_count(stream.DEGRID_KERNEL)
    with plain_kernels(torch):
        ref_p = ds.aw_predict_vis(vd, ak, model, **kw)
    err_pred = rel_l2(pred.vis.cpu().numpy(), ref_p.vis.cpu().numpy())
    print(f"S=48 predict main path: aw_predict_vis of phase 8's model to "
          f"{n_vis} vis, peak |vis| {pred.peak:.6g}, n_dropped "
          f"{pred.n_dropped}, degridder launches {launches_d}; vs the plain "
          f"degridder rel-L2 {err_pred:.3e} (bound {KERNEL_TOL})")
    if not torch.isfinite(pred.vis).all():
        raise AssertionError("S=48 IDG-AW prediction has non-finite values")
    if pred.n_dropped != 0:
        raise AssertionError(f"S=48 IDG-AW predict dropped {pred.n_dropped}")
    if launches_d < 1:
        raise AssertionError("aw_predict_vis(subgrid=48) did not launch the "
                             "streamed degridder")
    if not err_pred <= KERNEL_TOL:
        raise AssertionError(f"S=48 IDG-AW predict parity failed: "
                             f"{err_pred}")

    # ---- 26c. times ----------------------------------------------------------
    ms = {}
    for label, fn in (
            ("gridder kernel (CUDA)",
             lambda: stream.idg_aw_grid_from_records_stream(
                 *recs[:7], shape, scr, **kg)),
            ("gridder plain (PyTorch)",
             lambda: stream.grid_from_records_plain(
                 *recs[:7], scr, grid_shape=shape, **kg)),
            ("degridder kernel (CUDA)",
             lambda: stream.idg_aw_degrid_from_records_stream(
                 *drecs[:7], d.grid, scr, **kg)),
            ("degridder plain (PyTorch)",
             lambda: stream.degrid_from_records_plain(
                 *drecs[:7], d.grid, scr, **kg)),
            ("aw_idg_image end to end",
             lambda: ds.aw_idg_image(vd, ak, **kw)),
            ("aw_predict_vis end to end",
             lambda: ds.aw_predict_vis(vd, ak, model, **kw))):
        ms[label] = t = timed_ms(torch, fn)
        print(f"time S=48 {label}: {t:.3f} ms = {n_vis / t / 1e3:.2f} M "
              f"vis/s [{card}]")
    n_druns = int(((drecs[1][1:] > drecs[1][:-1])
                   & (drecs[4] < PAIR_SHIFT)).sum())
    entries = []
    for name, label, n_r, io, max_abs, launches, replaces in (
            (stream.GRID_KERNEL, "gridder", n_runs,
             nbytes(*recs[:7], scr) + (shape[0] + 2 * S) ** 2 * 8,
             max_abs_g, launches_g,
             "ska_sdp_tpu/kernels/idg_aw_stream_pallas.py:161"),
            (stream.DEGRID_KERNEL, "degridder", n_druns,
             nbytes(*drecs[:7], scr, d.grid) + n_vis * 8, max_abs_d,
             launches_d,
             "ska_sdp_tpu/kernels/idg_aw_stream_pallas.py:475")):
        (f_ms, f_by), (b_ms, b_by, t_tc, t_cuda) = idg_stream_bounds(
            S, n_vis, n_r, io)
        t = ms[f"{label} kernel (CUDA)"]
        print(f"idg {label} bounds at S=48 ({n_r} runs, {n_vis} records): "
              f"f32 {f_ms:.3f} ms ({f_by}); tensor core {b_ms:.3f} ms "
              f"({b_by}: split3 products {t_tc:.3f} ms, phase factors, "
              f"screens and sandwiches on the CUDA cores {t_cuda:.3f} ms, "
              f"bytes {io / HBM_BPS * 1e3:.3f} ms); the kernel at "
              f"{100 * b_ms / t:.1f}% of it")
        entries.append({
            "name": f"{name} (aw_idg S=48)", "route": "cuda",
            "source": f"ska_sdp_tpu_torch/csrc/{name[:-7]}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs, "ms": t,
            "plain_ms": ms[f"{label} plain (PyTorch)"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None})
    return entries


def psf_phases(torch, dev, card, vd, obs):
    """Phase 27: the PSF-normalised imaging (``do_imaging``) of ``--mode
    simple``, ``conv`` and ``wcache`` on the main path's observation
    ``vd``/``obs``.  Returns the bank scatter's entries of the ``kernels``
    line for ``conv`` and ``wcache``, and the w-kernel synthesis's, each
    with its launches in that main-path call."""
    from ska_sdp_tpu_torch.kernels import wkernel_synth as synth
    from ska_sdp_tpu_torch.kernels import wproj
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.models import imaging
    from ska_sdp_tpu_torch.ops.fourier import ifft_centered, pad_mid
    from ska_sdp_tpu_torch.ops.gridding import convgrid_wproj
    from ska_sdp_tpu_torch.ops.wkernel import (extract_oversampled,
                                               w_kernel_taps_plain)

    n_vis = vd.vis.shape[0]
    kw = dict(theta=THETA, lam=LAM, device=dev)
    real_gridder = imaging.wproj_gridder
    entries = []
    # the synthesis's launches a call: a bank for the image and another for
    # the PSF in wcache, conv's one kernel, none in simple
    synth_expected = {"simple": 0, "conv": 1, "wcache": 2}
    for mode in ("simple", "conv", "wcache"):
        calls, synth_calls = [], []

        def grid_spy(bank, shape, p, wbin, vis, chunk):
            out = real_gridder(bank, shape, p, wbin, vis, chunk=chunk)
            calls.append((bank, shape, p, wbin, vis, out))
            return out

        wproj.reset_launch_count()
        synth.reset_launch_count()
        imaging.wproj_gridder = grid_spy
        try:
            with spy(synth, "wkernel_synth", synth_calls):
                res = ds.psf_image(vd, mode, **kw)
            torch.cuda.synchronize()
        finally:
            imaging.wproj_gridder = real_gridder
        launches = wproj.launch_count(wproj.GRID_KERNEL)
        synth_launches = synth.launch_count()
        img = res.image.cpu().numpy()
        n = img.shape[0]
        print(f"do_imaging main path: --mode {mode} {n}² from "
              f"{n_vis} vis, PSF peak {float(res.pmax):.6g}, image max "
              f"{img.max():.6g}, bank scatter launches {launches}, "
              f"launches/wkernel_synth {synth_launches}")
        if synth_launches != synth_expected[mode] \
                or len(synth_calls) != synth_launches:
            raise AssertionError(f"--mode {mode}: {synth_launches} "
                                 f"w-kernel synthesis launches, not "
                                 f"{synth_expected[mode]}")
        if not (np.isfinite(img).all()
                and torch.isfinite(res.psf).all()):
            raise AssertionError(f"--mode {mode}: non-finite image or PSF")
        if abs(float(res.psf.max()) - 1.0) > 1e-6:
            raise AssertionError(f"--mode {mode}: PSF not normalised")
        if mode == "simple":
            # no hand-written kernel on this path: one index_add_ scatter
            if launches != 0:
                raise AssertionError("--mode simple launched the scatter")
            peak_at_source(img, obs["sources"], "do_imaging --mode simple")
            continue
        if launches != 2 or len(calls) != 2:
            raise AssertionError(f"--mode {mode}: {launches} launches, not "
                                 "2 (image and PSF)")
        errs, max_abs = [], 0.0
        for bank, shape, p, wbin, vis, out in calls:
            ref = convgrid_wproj(bank, torch.zeros(
                shape, dtype=torch.complex64, device=dev), p, wbin, vis,
                chunk=8192)
            on, rn = out.cpu().numpy(), ref.cpu().numpy()
            errs.append(rel_l2(on, rn))
            max_abs = max(max_abs, float(np.abs(on - rn).max()))
        s_errs, s_max = [], 0.0
        for args, kwargs, out in synth_calls:
            ref = w_kernel_taps_plain(*args, **kwargs)
            on, rn = out.cpu().numpy(), ref.cpu().numpy()
            s_errs.append(rel_l2(on, rn))
            s_max = max(s_max, float(np.abs(on - rn).max()))
        s_tol = SYNTH_TOL[str(synth_calls[0][2].dtype).split(".")[-1]]
        with plain_kernels(torch):
            ref = ds.psf_image(vd, mode, **kw)
        err_img = rel_l2(img, ref.image.cpu().numpy())
        err_psf = rel_l2(res.psf.cpu().numpy(), ref.psf.cpu().numpy())
        bank = calls[0][0]
        print(f"  bank {tuple(bank.shape)} ({bank.shape[0]} plane"
              f"{'s' if bank.shape[0] > 1 else ''}); each launch vs the "
              f"plain scatter on its inputs rel-L2 "
              f"{', '.join(f'{e:.3e}' for e in errs)} (bound {KERNEL_TOL}); "
              f"each synthesis vs the plain version on its screens rel-L2 "
              f"{', '.join(f'{e:.3e}' for e in s_errs)} (bound {s_tol}); "
              f"image and PSF vs the same entry on the plain scatter and "
              f"synthesis rel-L2 {err_img:.3e}, {err_psf:.3e} (bound "
              f"{IMAGE_TOL})")
        if max(errs) > KERNEL_TOL:
            raise AssertionError(f"--mode {mode} scatter parity: {errs}")
        if max(s_errs) > s_tol:
            raise AssertionError(f"--mode {mode} synthesis parity: {s_errs}")
        if not (err_img <= IMAGE_TOL and err_psf <= IMAGE_TOL):
            raise AssertionError(f"--mode {mode} do_imaging parity: {err_img}, "
                                 f"{err_psf}")

        # times of the image launch's records, and its bound: 8 flop per
        # in-bounds tap, the inputs read once and the grid written once
        bank, shape, p, wbin, vis, _ = calls[0]
        t_k = timed_ms(torch, lambda: wproj.wproj_gridder(
            bank, shape, p, wbin, vis))
        t_p = timed_ms(torch, lambda: convgrid_wproj(bank, torch.zeros(
            shape, dtype=torch.complex64, device=dev), p, wbin, vis,
            chunk=8192))
        nw, qpx, _, gh, gw = bank.shape
        y0, x0, _, valid = wproj.wproj_records(shape, qpx, gh, gw,
                                               nw * qpx * qpx, p, wbin)
        rows = torch.clamp(y0 + gh, max=shape[0]) - torch.clamp(y0, min=0)
        cols = torch.clamp(x0 + gw, max=shape[1]) - torch.clamp(x0, min=0)
        taps = int((rows.clamp(min=0) * cols.clamp(min=0))[valid].sum())
        b_ms, b_by = bound(8 * taps, nbytes(bank, p, wbin, vis)
                           + shape[0] * shape[1] * 8)
        print(f"time --mode {mode} scatter kernel (CUDA): {t_k:.3f} ms, "
              f"plain (PyTorch) {t_p:.3f} ms; bound {b_ms:.3f} ms ({b_by}; "
              f"{taps} in-bounds taps) [{card}]")
        entries.append({
            "name": f"{wproj.GRID_KERNEL} (do_imaging {mode})",
            "route": "cuda", "source": "ska_sdp_tpu_torch/csrc/wproj_grid.cu",
            "replaces": "ska_sdp_tpu/kernels/wproj_resident_pallas.py:76, "
                        "ska_sdp_tpu/kernels/wproj_pallas.py:77",
            "launches": launches, "max_abs_err": max_abs, "ms": t_k,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})

        # the synthesis of the image's bank: the kernel, its plain version
        # and the padded transform (pad, centred cuFFT, extract) it replaces
        (scr, qpx, s), skw, sout = synth_calls[0]
        t_s = timed_ms(torch, lambda: synth.wkernel_synth(scr, qpx, s, **skw))
        t_sp = timed_ms(torch, lambda: w_kernel_taps_plain(scr, qpx, s,
                                                           **skw))
        t_sl = timed_ms(torch, lambda: extract_oversampled(ifft_centered(
            pad_mid(scr, scr.shape[-1] * qpx)), qpx, s))
        sb_ms, sb_by = bound(synth_flop(*scr.shape[:2], qpx * s),
                             nbytes(scr, sout))
        print(f"time --mode {mode} synthesis kernel (CUDA, {scr.shape[0]} "
              f"planes, {scr.shape[-1]}² screens, qpx {qpx}, support {s}): "
              f"{t_s:.3f} ms, plain (PyTorch) {t_sp:.3f} ms, pad + cuFFT "
              f"{t_sl:.3f} ms; bound {sb_ms:.4f} ms ({sb_by}) [{card}]")
        entries.append({
            "name": f"{synth.KERNEL} (do_imaging {mode})", "route": "cuda",
            "source": "ska_sdp_tpu_torch/csrc/wkernel_synth.cu",
            "replaces": "none: XLA's pad and FFT in "
                        "ska_sdp_tpu/ops/wkernel.py::w_kernel",
            "launches": synth_launches, "max_abs_err": s_max, "ms": t_s,
            "plain_ms": t_sp, "bound_ms": sb_ms, "bound_by": sb_by,
            "library_ms": t_sl})
    for mode in ("simple", "conv", "wcache"):
        t = timed_ms(torch, lambda: ds.psf_image(vd, mode, **kw))
        print(f"time do_imaging --mode {mode} end to end (image + PSF): "
              f"{t:.3f} ms = {n_vis / t / 1e3:.2f} M vis/s [{card}]")
    return entries


@contextlib.contextmanager
def spy(mod, attr, calls):
    """Record ``(args, kwargs, result)`` of every call of ``mod.attr``."""
    real = getattr(mod, attr)

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(mod, attr, wrapper)
    try:
        yield
    finally:
        setattr(mod, attr, real)


def wall_ms(torch, fn, reps=5):
    """Median host-clock milliseconds of ``fn()`` ended by a synchronise
    (one warm-up run): for loops that wait on the host."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def scatter_entry(torch, card, label, call, launches):
    """The ``kernels`` entry of one recorded bank scatter call (``args``
    of ``wproj_gridder``, its ``init`` included): the kernel against the
    plain scatter on the same inputs, both timed, and the bound (8 flop
    per in-bounds tap; inputs, ``init`` included, read once and the grid
    written once)."""
    from ska_sdp_tpu_torch.kernels import wproj
    from ska_sdp_tpu_torch.ops.gridding import convgrid_wproj

    (bank, shape, p, wbin, vis), kw, out = call
    init = kw.get("init")

    def plain():
        g0 = (torch.zeros(shape, dtype=torch.complex64, device=vis.device)
              if init is None else init)
        return convgrid_wproj(bank, g0, p, wbin, vis, chunk=8192)

    ref = plain()
    on, rn = out.cpu().numpy(), ref.cpu().numpy()
    err, max_abs = rel_l2(on, rn), float(np.abs(on - rn).max())
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{label} scatter parity failed: {err}")
    t_k = timed_ms(torch, lambda: wproj.wproj_gridder(bank, shape, p, wbin,
                                                      vis, init=init))
    t_p = timed_ms(torch, plain)
    nw, qpx, _, gh, gw = bank.shape
    y0, x0, _, valid = wproj.wproj_records(shape, qpx, gh, gw,
                                           nw * qpx * qpx, p, wbin)
    rows = torch.clamp(y0 + gh, max=shape[0]) - torch.clamp(y0, min=0)
    cols = torch.clamp(x0 + gw, max=shape[1]) - torch.clamp(x0, min=0)
    taps = int((rows.clamp(min=0) * cols.clamp(min=0))[valid].sum())
    io = nbytes(bank, p, wbin, vis) + shape[0] * shape[1] * 8 * (
        1 if init is None else 2)
    b_ms, b_by = bound(8 * taps, io)
    onto = "" if init is None else ", onto a grid"
    print(f"  {label} scatter ({p.shape[0]} records{onto}): "
          f"kernel vs plain rel-L2 {err:.3e} (bound {KERNEL_TOL}); kernel "
          f"{t_k:.3f} ms, plain {t_p:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{taps} in-bounds taps) [{card}]")
    return {"name": f"{wproj.GRID_KERNEL} ({label})", "route": "cuda",
            "source": "ska_sdp_tpu_torch/csrc/wproj_grid.cu",
            "replaces": "ska_sdp_tpu/kernels/wproj_resident_pallas.py:76, "
                        "ska_sdp_tpu/kernels/wproj_pallas.py:77",
            "launches": launches, "max_abs_err": max_abs, "ms": t_k,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def aw_entry(torch, card, label, call, launches):
    """The ``kernels`` entry of one recorded fused AW gridder call
    (``args`` of ``aw_fused_grid``, its ``init`` included): the kernel
    against the plain version on the same records and tables, both timed,
    and the bound (per valid record the least of the dense and the
    FFT-shaped sandwich, 6m² + 6s²; inputs read once, the grid written
    once)."""
    from ska_sdp_tpu_torch.kernels import aw_fused

    (pt, ws, rec, vis, shape), kw, out = call
    init = kw.get("init")

    def plain():
        g = aw_fused.aw_fused_plain(pt, ws, rec, vis, shape)
        return g if init is None else g + init

    on, rn = out.cpu().numpy(), plain().cpu().numpy()
    err, max_abs = rel_l2(on, rn), float(np.abs(on - rn).max())
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{label} kernel parity failed: {err}")
    t_k = timed_ms(torch, lambda: aw_fused.aw_fused_grid(pt, ws, rec, vis,
                                                         shape, init=init))
    t_p = timed_ms(torch, plain)
    s, m = rec.support, pt.shape[-1]
    per_rec = min(8 * (m * m * s + s * s * m),
                  (m + s) * 5 * m * int(math.log2(m))) + 6 * m * m + 6 * s * s
    b_ms, b_by = bound(int(rec.valid.sum()) * per_rec,
                       nbytes(pt, ws, rec.y0, rec.x0, rec.pid, rec.kidx,
                              vis) + shape[0] * shape[1] * 8 * (
                                  1 if init is None else 2))
    print(f"  {label} kernel: vs plain rel-L2 {err:.3e} (bound "
          f"{KERNEL_TOL}); kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound "
          f"{b_ms:.3f} ms ({b_by}) [{card}]")
    return {"name": f"{aw_fused.GRID_KERNEL} ({label})", "route": "cuda",
            "source": "ska_sdp_tpu_torch/csrc/aw_grid.cu",
            "replaces": "ska_sdp_tpu/kernels/aw_fused_resident_pallas.py:95, "
                        "ska_sdp_tpu/kernels/aw_fused_pallas.py:93, "
                        "ska_sdp_tpu/kernels/patch_scatter_pallas.py:41",
            "launches": launches, "max_abs_err": max_abs, "ms": t_k,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def run_surface_phases(torch, dev, card, vd, obs):
    """Phases 28-30: the staged drivers, the checkpointed slab loop and the
    streamed two-pass loop on the main path's observation ``vd``/``obs``,
    in memory (the card's machine has no h5py).  Returns the entries of the
    ``kernels`` line of the kernels they launch."""
    from ska_sdp_tpu_torch.kernels import aw_fused, wproj
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.models import runs
    from ska_sdp_tpu_torch.ops.gridding import convgrid_wproj
    from ska_sdp_tpu_torch.types import SINGLE
    from ska_sdp_tpu_torch.utils import hostmem
    from ska_sdp_tpu_torch.utils.timing import PhaseTimer

    n_vis = vd.vis.shape[0]
    n_grid = int(round(THETA * LAM))
    centers, build_bank = w_bank_inputs(torch, obs, dev)
    bank = build_bank()
    ak = main_akerns()
    kw = dict(theta=THETA, lam=LAM, device=dev)
    entries = []

    # ---- 28. the staged drivers (--device-phases) --------------------------
    uvw, f, vis = ds.idg_inputs(vd, device=dev)
    bank64 = bank.to(torch.complex64)
    bank_c = torch.conj(bank64).resolve_conj()
    cent32 = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    a1, a2 = (torch.as_tensor(a.astype(np.int32), device=dev)
              for a in (vd.antenna1, vd.antenna2))
    ak64 = torch.as_tensor(ak, dtype=torch.complex64, device=dev)
    scr = ds.antenna_screens(ak, SUBGRID, THETA, LAM, None, SINGLE, dev)
    mr = ds.aw_run_bound(vd.antenna1, vd.antenna2, n_vis)
    one_shot = {
        "w": lambda: ds.w_image(vd, bank, centers, **kw),
        "aw": lambda: ds.aw_image(vd, bank, centers, ak, **kw),
        "aw_idg": lambda: ds.aw_idg_image(vd, ak, subgrid=SUBGRID,
                                          taper_beta=BETA, **kw)}
    staged = {
        "w": (runs, "wproj_gridder", wproj, wproj.GRID_KERNEL, "scatter",
              lambda t: runs.wproj_staged(bank_c, cent32, uvw, f, vis,
                                          theta=THETA, lam=LAM, chunk=8192,
                                          timer=t)),
        "aw": (aw_fused, "aw_fused_grid", aw_fused, aw_fused.GRID_KERNEL,
               "aw-fused-kernel",
               lambda t: runs.aw_fused_staged(bank64, cent32, ak64, uvw, a1,
                                              a2, f, vis, theta=THETA,
                                              lam=LAM, chunk=8192, timer=t)),
        "aw_idg": (runs, "idg_aw_grid_from_records_stream", stream,
                   stream.GRID_KERNEL, "idg-aw-kernel",
                   lambda t: runs.aw_idg_staged(
                       scr, uvw, a1, a2, f, vis, theta=THETA, lam=LAM,
                       subgrid=SUBGRID, taper_beta=BETA, max_runs=mr,
                       timer=t))}
    captured = {}
    for kind, (mod, attr, counter, kname, stage, run) in staged.items():
        ref = one_shot[kind]()
        torch.cuda.synchronize()
        calls = []
        timer = PhaseTimer(enabled=True)
        print(f"staged {kind} (in memory, {n_vis} vis; each stage a warm-up "
              f"and a timed call) [{card}]:")
        counter.reset_launch_count()
        with spy(mod, attr, calls):
            out = run(timer)
            torch.cuda.synchronize()
        launches = counter.launch_count(kname)
        img, img_r = out[0].cpu().numpy(), ref[0].cpu().numpy()
        nd, region = "", ""
        if kind == "aw_idg":
            # IDG's image contract holds over the central 75%: outside it
            # the taper division amplifies the rounding of sums taken in
            # another order (the staged prep sorts, the entry does not)
            nd = (f"; n_dropped staged {out[2]}, unstaged {ref[2]}; full "
                  f"image (no bound) {rel_l2(img, img_r):.3e}")
            img, img_r, region = crop75(img), crop75(img_r), " (central 75%)"
        err = rel_l2(img, img_r)
        print(f"  vs the unstaged entry: rel-L2 {err:.3e}{region} (bound "
              f"{STAGED_TOL}); {kname} launches {launches} (warm-up and "
              f"timed {stage}){nd}")
        if not np.isfinite(img).all():
            raise AssertionError(f"staged {kind}: non-finite image")
        if launches < 1 or len(calls) != 2:
            raise AssertionError(f"staged {kind}: {launches} launches")
        if not err <= STAGED_TOL:
            raise AssertionError(f"staged {kind} image parity: {err}")
        if kind == "aw_idg" and out[2] != ref[2]:
            raise AssertionError(f"staged IDG-AW dropped {out[2]}, the "
                                 f"entry {ref[2]}")
        captured[kind] = (calls[-1], launches)

    call, launches = captured["w"]
    entries.append(scatter_entry(torch, card, "staged w", call, launches))
    entries.append(aw_entry(torch, card, "staged aw", *captured["aw"]))
    args, gkw, out = captured["aw_idg"][0]
    recs, shape, scr_k = args[:7], args[7], args[8]
    S = SUBGRID

    def plain_idg():
        return stream.grid_from_records_plain(
            *recs, scr_k, grid_shape=shape, **gkw)[S:S + shape[0],
                                                  S:S + shape[1]]

    on, rn = out.cpu().numpy(), plain_idg().cpu().numpy()
    err, max_abs = rel_l2(on, rn), float(np.abs(on - rn).max())
    if not err <= KERNEL_TOL:
        raise AssertionError(f"staged aw_idg kernel parity failed: {err}")
    t_k = timed_ms(torch, lambda: stream.idg_aw_grid_from_records_stream(
        *recs, shape, scr_k, **gkw))
    t_p = timed_ms(torch, plain_idg, reps=3)
    n_runs, longest, mean = run_stats(recs[1], recs[2])
    io = nbytes(*recs, scr_k) + (shape[0] + 2 * S) ** 2 * 8
    _, (b_ms, b_by, t_tc, t_cuda) = idg_stream_bounds(S, n_vis, n_runs, io)
    print(f"  staged aw_idg kernel (S={S}, {n_runs} runs, longest {longest}, "
          f"mean {mean:.2f}): vs plain rel-L2 {err:.3e} (bound "
          f"{KERNEL_TOL}); kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
          f"tensor-core bound {b_ms:.3f} ms ({b_by}) [{card}]")
    entries.append({
        "name": f"{stream.GRID_KERNEL} (staged aw_idg S={S})",
        "route": "cuda", "source": "ska_sdp_tpu_torch/csrc/idg_grid.cu",
        "replaces": "ska_sdp_tpu/kernels/idg_aw_stream_pallas.py:161, "
                    "ska_sdp_tpu/kernels/idg_aw_pallas.py:360",
        "launches": captured["aw_idg"][1], "max_abs_err": max_abs,
        "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None})
    del captured

    # ---- 29. the checkpointed slab loop -------------------------------------
    img_w = one_shot["w"]().image.cpu().numpy()
    slab_ms, copies = [], []

    def timed_scatter(calls):
        """``wproj_gridder`` timed by CUDA events around each call."""
        real = ds.wproj_gridder

        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args, **kwargs)
            stop.record()
            slab_ms.append((start, stop))
            calls.append((args, kwargs, out))
            return out

        return wrapper

    copy = hostmem.HostCopy()        # what the checkpoint writer copies with

    def to_host(grid, nxt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = copy(grid)
        copies.append(((time.perf_counter() - t0) * 1e3, g.nbytes, nxt, g))

    calls = []
    n_slabs = -(-n_vis // SLAB)
    real_scatter = ds.wproj_gridder
    wproj.reset_launch_count()
    ds.wproj_gridder = timed_scatter(calls)
    try:
        t0 = time.perf_counter()
        first = ds.w_image_slabs(vd, bank, centers, slab=SLAB, max_slabs=2,
                                 on_slab=to_host, **kw)
        _, _, start, grid = copies[-1]
        res = ds.w_image_slabs(vd, bank, centers, slab=SLAB, start=start,
                               grid=grid, on_slab=to_host, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        ds.wproj_gridder = real_scatter
    launches = wproj.launch_count(wproj.GRID_KERNEL)
    img = res.image.cpu().numpy()
    err = rel_l2(img, img_w)
    print(f"checkpointed main path: w_image_slabs of {n_vis} vis in slabs "
          f"of {SLAB}, stopped after 2 (next {start}) and resumed from the "
          f"host copy: scatter launches {launches} (expected {n_slabs}); "
          f"image vs "
          f"w_image rel-L2 {err:.3e} (bound {STAGED_TOL}); both calls "
          f"{wall:.3f} ms [{card}]")
    if first is not None or start != 2 * SLAB:
        raise AssertionError("the slab loop did not stop after 2 slabs")
    if launches != n_slabs or not np.isfinite(img).all():
        raise AssertionError(f"checkpointed run: {launches} launches")
    if not err <= STAGED_TOL:
        raise AssertionError(f"checkpointed image parity failed: {err}")
    for i, ((a, b), (c_ms, c_bytes, nxt, _)) in enumerate(zip(slab_ms,
                                                              copies)):
        print(f"  slab {i}: scatter {a.elapsed_time(b):.3f} ms (CUDA "
              f"events, the grid's copy into the output included), host "
              f"copy (page-locked) {c_ms:.3f} ms of {c_bytes} bytes "
              f"({c_bytes / c_ms / 1e6:.2f} GB/s), next {nxt}")
    copies.clear()
    entries.append(scatter_entry(torch, card, "checkpointed slab",
                                 calls[1], launches))
    final = calls[-1][2]
    t_pin = wall_ms(torch, lambda: copy(final))
    t_page = wall_ms(torch, lambda: final.cpu())
    nb = final.numel() * final.element_size()
    print(f"time host copy of the {nb}-byte grid: page-locked buffer "
          f"(HostCopy) {t_pin:.3f} ms ({nb / t_pin / 1e6:.2f} GB/s), "
          f"pageable (grid.cpu()) {t_page:.3f} ms "
          f"({nb / t_page / 1e6:.2f} GB/s) [{card}]")

    def keep(grid, nxt):
        copy(grid)

    def keep_pageable(grid, nxt):
        grid.cpu()

    t_w = wall_ms(torch, one_shot["w"])
    t_4 = wall_ms(torch, lambda: ds.w_image_slabs(
        vd, bank, centers, slab=SLAB, on_slab=keep, **kw))
    t_4p = wall_ms(torch, lambda: ds.w_image_slabs(
        vd, bank, centers, slab=SLAB, on_slab=keep_pageable, **kw))
    t_1 = wall_ms(torch, lambda: ds.w_image_slabs(
        vd, bank, centers, slab=1 << 20, on_slab=keep, **kw))
    print(f"time w_image {t_w:.3f} ms; w_image_slabs with a host copy a "
          f"slab: 4 slabs of {SLAB} {t_4:.3f} ms (pageable copies "
          f"{t_4p:.3f} ms), the default slab {1 << 20} (one slab) "
          f"{t_1:.3f} ms [{card}]")

    # ---- 30. the streamed two-pass loop -------------------------------------
    readers = {"uvw": lambda s0, c: vd.uvw[s0:s0 + c],
               "vis": lambda s0, c: vd.vis[s0:s0 + c]}
    counts = ds.stream_weight_counts(readers["uvw"], n_vis, vd.frequency,
                                     theta=THETA, lam=LAM, slab=SLAB,
                                     device=dev)
    uvw_l = vd.uvw * (vd.frequency / C) / LAM
    cell = np.floor(n_grid // 2 + uvw_l[:, :2] * n_grid + 0.5).astype(
        np.int64)
    flat = cell[:, 1] * n_grid + cell[:, 0]
    want = np.bincount(flat[(flat >= 0) & (flat < n_grid ** 2)],
                       minlength=n_grid ** 2)
    occupied = int((want > 0).sum())
    want[want == 0] = 1
    same = np.array_equal(counts.cpu().numpy(), want)
    print(f"out-of-core weights: pass-1 histogram of {n_vis} records on the "
          f"card equals the float64 numpy histogram: {same} (occupied cells "
          f"{occupied}, max count {int(want.max())})")
    if not same:
        raise AssertionError("the streamed histogram differs from numpy's")
    timer = PhaseTimer()
    calls = []
    wproj.reset_launch_count()
    with spy(ds, "wproj_gridder", calls):
        res = ds.w_image_streamed(readers, n_vis, vd.frequency, bank,
                                  centers, slab=SLAB, timer=timer, **kw)
        torch.cuda.synchronize()
    launches = wproj.launch_count(wproj.GRID_KERNEL)
    img = res.image.cpu().numpy()

    def plain_scatter(bank, shape, p, wbin, vis, chunk, init):
        return convgrid_wproj(bank, init, p, wbin, vis, chunk=chunk)

    ds.wproj_gridder = plain_scatter
    try:
        ref = ds.w_image_streamed(readers, n_vis, vd.frequency, bank,
                                  centers, slab=SLAB, **kw)
    finally:
        ds.wproj_gridder = real_scatter
    err = rel_l2(img, ref.image.cpu().numpy())
    print(f"out-of-core main path: w_image_streamed of {n_vis} vis in slabs "
          f"of {SLAB}: scatter launches {launches} (expected {n_slabs}); "
          f"image vs "
          f"the same loop on the plain scatter rel-L2 {err:.3e} (bound "
          f"{STAGED_TOL}); vs w_image (no bound: the streamed weights) "
          f"{rel_l2(img, img_w):.3e}; histogram pass "
          f"{timer.times['weight/histogram'] * 1e3:.3f} ms, prefetch wait "
          f"{timer.times['stream/prefetch-wait'] * 1e3:.3f} ms over both "
          f"passes [{card}]")
    if launches != n_slabs or not np.isfinite(img).all():
        raise AssertionError(f"streamed run: {launches} launches")
    if not err <= STAGED_TOL:
        raise AssertionError(f"streamed image parity failed: {err}")
    entries.append(scatter_entry(torch, card, "out-of-core slab", calls[1],
                                 launches))
    t_h = wall_ms(torch, lambda: ds.stream_weight_counts(
        readers["uvw"], n_vis, vd.frequency, theta=THETA, lam=LAM, slab=SLAB,
        device=dev))
    waits = []

    def streamed():
        t = PhaseTimer()
        ds.w_image_streamed(readers, n_vis, vd.frequency, bank, centers,
                            slab=SLAB, timer=t, on_slab=keep, **kw)
        waits.append(t.times["stream/prefetch-wait"] * 1e3)

    t_s = wall_ms(torch, streamed)
    print(f"time out-of-core: histogram pass {t_h:.3f} ms; w_image_streamed "
          f"with a host copy a slab {t_s:.3f} ms (prefetch wait median "
          f"{statistics.median(waits):.3f} ms); w_image {t_w:.3f} ms "
          f"[{card}]")
    return entries


GRID_BYTES = 2400 * 2400 * 8       # the main path's complex64 uv-grid


def allreduce_ms(torch, mesh) -> float:
    """Median time of one ``all_reduce`` of a 2400² complex64 grid on the
    mesh (CUDA events)."""
    from ska_sdp_tpu_torch.parallel.mesh import all_reduce_

    g = torch.zeros((2400, 2400), dtype=torch.complex64, device=mesh.device)
    return timed_ms(torch, lambda: all_reduce_(g, mesh))


def gather_entry(torch, card, label, call, launches):
    """The ``kernels`` entry of one recorded bank gather call (``args`` of
    ``wproj_degridder``): the kernel against the plain gather on the same
    inputs, both timed, and the bound (8 flop per in-bounds tap; inputs
    read once and the visibilities written once)."""
    from ska_sdp_tpu_torch.kernels import wproj
    from ska_sdp_tpu_torch.ops.gridding import degrid_wproj

    (bank, grid, p, wbin), kw, out = call
    ref = degrid_wproj(bank, grid, p, wbin, chunk=8192)
    on, rn = out.cpu().numpy(), ref.cpu().numpy()
    err, max_abs = rel_l2(on, rn), float(np.abs(on - rn).max())
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{label} gather parity failed: {err}")
    t_k = timed_ms(torch, lambda: wproj.wproj_degridder(bank, grid, p, wbin))
    t_p = timed_ms(torch, lambda: degrid_wproj(bank, grid, p, wbin,
                                               chunk=8192))
    nw, qpx, _, gh, gw = bank.shape
    shape = tuple(grid.shape)
    y0, x0, _, valid = wproj.wproj_records(shape, qpx, gh, gw,
                                           nw * qpx * qpx, p, wbin)
    rows = torch.clamp(y0 + gh, max=shape[0]) - torch.clamp(y0, min=0)
    cols = torch.clamp(x0 + gw, max=shape[1]) - torch.clamp(x0, min=0)
    taps = int((rows.clamp(min=0) * cols.clamp(min=0))[valid].sum())
    b_ms, b_by = bound(8 * taps, nbytes(bank, grid, p, wbin, out))
    print(f"  {label} gather ({p.shape[0]} records): kernel vs plain rel-L2 "
          f"{err:.3e} (bound {KERNEL_TOL}); kernel {t_k:.3f} ms, plain "
          f"{t_p:.3f} ms, bound {b_ms:.4f} ms ({b_by}; {taps} in-bounds taps) "
          f"[{card}]")
    return {"name": f"{wproj.DEGRID_KERNEL} ({label})", "route": "cuda",
            "source": "ska_sdp_tpu_torch/csrc/wproj_degrid.cu",
            "replaces": "ska_sdp_tpu/kernels/wproj_degrid_resident_pallas.py"
                        ":39, ska_sdp_tpu/kernels/wproj_degrid_pallas.py:47",
            "launches": launches, "max_abs_err": max_abs, "ms": t_k,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def stream_grid_entry(torch, card, label, call, launches, n_rec):
    """The ``kernels`` entry of one recorded streamed gridder call (``args``
    of ``idg_aw_grid_from_records_stream``): the kernel against its plain
    version on the same records, both timed, and the tensor-core bound."""
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream

    args, gkw, out = call
    recs, shape, scr = args[:7], args[7], args[8]
    S = gkw["subgrid"]

    def plain():
        return stream.grid_from_records_plain(
            *recs, scr, grid_shape=shape, **gkw)[S:S + shape[0],
                                                 S:S + shape[1]]

    on, rn = out.cpu().numpy(), plain().cpu().numpy()
    err, max_abs = rel_l2(on, rn), float(np.abs(on - rn).max())
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{label} gridder parity failed: {err}")
    t_k = timed_ms(torch, lambda: stream.idg_aw_grid_from_records_stream(
        *recs, shape, scr, **gkw))
    t_p = timed_ms(torch, plain, reps=3)
    n_runs, longest, mean = run_stats(recs[1], recs[2])
    io = nbytes(*recs, scr) + (shape[0] + 2 * S) ** 2 * 8
    _, (b_ms, b_by, _, _) = idg_stream_bounds(S, n_rec, n_runs, io)
    print(f"  {label} gridder (S={S}, {n_runs} runs, longest {longest}, "
          f"mean {mean:.2f}): vs plain rel-L2 {err:.3e} (bound "
          f"{KERNEL_TOL}); kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
          f"tensor-core bound {b_ms:.3f} ms ({b_by}) [{card}]")
    return {"name": f"{stream.GRID_KERNEL} ({label})", "route": "cuda",
            "source": "ska_sdp_tpu_torch/csrc/idg_grid.cu",
            "replaces": "ska_sdp_tpu/kernels/idg_aw_stream_pallas.py:161, "
                        "ska_sdp_tpu/kernels/idg_aw_pallas.py:360",
            "launches": launches, "max_abs_err": max_abs, "ms": t_k,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def scaleout_phases(torch, dev, card, vd, obs, model):
    """Phases 31-35: the sharded steps of ``ska_sdp_tpu_torch.parallel`` and
    the sharded cube core at world size 1 on NCCL (one card: NCCL puts no
    two ranks on one GPU), each against its unsharded chain on the card.
    The process group lives only for these phases.  Returns the entries of
    the ``kernels`` line of the kernels they launch."""
    import torch.distributed as dist

    from ska_sdp_tpu_torch.parallel import initialize, make_mesh

    if dist.is_initialized():
        raise AssertionError("a process group exists before phase 31")
    initialize(device=dev)
    try:
        mesh = make_mesh(device=dev)
        print(f"scale-out: process group on {dist.get_backend()}, world "
              f"size {mesh.size}, rank {mesh.rank} on {mesh.device} "
              f"(one card: every exchange is the rank's own) [{card}]")
        return _scaleout(torch, dev, card, vd, obs, model, mesh)
    finally:
        dist.destroy_process_group()


def _scaleout(torch, dev, card, vd, obs, model, mesh):
    from ska_sdp_tpu_torch import parallel as par
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.kernels import idg_tile, wproj
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.models import spectral as sp
    from ska_sdp_tpu_torch.parallel import sharded
    from ska_sdp_tpu_torch.types import SINGLE

    make = dict(w=par.make_sharded_wproj_step,
                gridfft=par.make_sharded_wproj_step_gridfft,
                gridscatter=par.make_sharded_wproj_step_gridscatter,
                idg=par.make_sharded_idg_step,
                predict=par.make_sharded_predict_step,
                aw=par.make_sharded_idg_aw_step)
    n_vis = vd.vis.shape[0]
    n = int(round(THETA * LAM))
    centers, build_bank = w_bank_inputs(torch, obs, dev)
    bank = build_bank().to(torch.complex64)
    bank_c = torch.conj(bank).resolve_conj()
    cent = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    uvw, f, vis = ds.idg_inputs(vd, device=dev)
    freq = vd.frequency
    kw = dict(theta=THETA, lam=LAM, device=dev)
    entries = []

    def phase_line(label, ms, launches):
        print(f"  {label}: wall {ms:.3f} ms (median of 3 after a warm-up), "
              f"launches {launches}, all_reduce of the {GRID_BYTES:,}-byte "
              f"grid {allreduce_ms(torch, mesh):.3f} ms [{card}]")

    # ---- 31. the w steps: replicated, pencil-FFT and reduce-scatter -------
    ref_w = ds.w_image(vd, bank, centers, **kw).image.cpu().numpy()
    for label in ("w", "gridfft", "gridscatter"):
        step = make[label](mesh, THETA, LAM)
        calls = []
        wproj.reset_launch_count()
        with spy(sharded, "wproj_gridder", calls):
            img = step(bank_c, cent, uvw, freq, vis)
            torch.cuda.synchronize()
        launches = wproj.launch_count(wproj.GRID_KERNEL)
        img = img.cpu().numpy()
        err = rel_l2(img, ref_w)
        print(f"sharded {label} step ({n_vis} vis, {n}², 32-plane qpx=8 "
              f"bank): image vs w_image rel-L2 {err:.3e} (bound "
              f"{IMAGE_TOL}); wproj_grid launches {launches} (expected 1)")
        phase_line(f"sharded {label} step", wall_ms(torch, lambda: step(
            bank_c, cent, uvw, freq, vis), reps=3), launches)
        if launches != 1 or not np.isfinite(img).all():
            raise AssertionError(f"sharded {label} step: {launches} "
                                 "launches or a non-finite image")
        if not err <= IMAGE_TOL:
            raise AssertionError(f"sharded {label} step image: {err}")
        if label == "w":
            entries.append(scatter_entry(torch, card, "sharded w step",
                                         calls[0], launches))

    # ---- 32. the IDG step at S=64 and S=32 ---------------------------------
    for S in (64, 32):
        step = make["idg"](mesh, THETA, LAM, subgrid=S, taper_beta=BETA)
        stream.reset_launch_count()
        idg_tile.reset_launch_count()
        img = step(uvw, freq, vis)
        torch.cuda.synchronize()
        route, launches = route_launches(stream, idg_tile, "grid")
        ref, _, _ = ds.idg_pipeline(uvw, f, vis, theta=THETA, lam=LAM,
                                    subgrid=S, taper_beta=BETA)
        img, ref = img.cpu().numpy(), ref.cpu().numpy()
        err = rel_l2(crop75(img), crop75(ref))
        print(f"sharded IDG step S={S}: image vs the unsharded chain on the "
              f"card rel-L2 {err:.3e} over the central 75% (bound "
              f"{IMAGE_TOL}); idg_grid launches {launches}, through the "
              f"fixed-tile route {route}")
        phase_line(f"sharded IDG step S={S}", wall_ms(
            torch, lambda: step(uvw, freq, vis), reps=3), launches)
        if launches != 1 or not np.isfinite(img).all():
            raise AssertionError(f"sharded IDG step S={S}: {launches}")
        if not err <= IMAGE_TOL:
            raise AssertionError(f"sharded IDG step S={S} image: {err}")

    # ---- 33. the predict step -----------------------------------------------
    step = make["predict"](mesh, THETA, LAM)
    model_t = torch.as_tensor(model, device=dev)
    calls = []
    wproj.reset_launch_count()
    with spy(ds, "wproj_degridder", calls):
        pred = step(bank, cent, model_t, uvw, freq)
        torch.cuda.synchronize()
    launches = wproj.launch_count(wproj.DEGRID_KERNEL)
    ref = ds.w_predict_vis(vd, bank, centers, model, **kw).vis
    err = rel_l2(pred.cpu().numpy(), ref.cpu().numpy())
    print(f"sharded predict step ({n_vis} records): vs w_predict_vis rel-L2 "
          f"{err:.3e} (bound {KERNEL_TOL}); wproj_degrid launches "
          f"{launches} (expected 1)")
    phase_line("sharded predict step", wall_ms(torch, lambda: step(
        bank, cent, model_t, uvw, freq), reps=3), launches)
    if launches != 1 or not err <= KERNEL_TOL:
        raise AssertionError(f"sharded predict: {launches} launches, {err}")
    entries.append(gather_entry(torch, card, "sharded predict", calls[0],
                                launches))

    # ---- 34. the IDG-AW step on the benchmark's track shape ---------------
    t = aw_track_inputs()
    uvw_t, f_t, vis_t = ds.idg_inputs(t.vd, device=dev)
    a1 = torch.as_tensor(t.a1.astype(np.int32), device=dev)
    a2 = torch.as_tensor(t.a2.astype(np.int32), device=dev)
    scr = ds.antenna_screens(t.ak, SUBGRID, THETA, LAM, None, SINGLE, dev)
    mr = ds.aw_run_bound(t.a1, t.a2, t.n)      # the rank's shard: all
    step = make["aw"](mesh, THETA, LAM, subgrid=SUBGRID, taper_beta=BETA,
                      max_runs=mr)
    calls = []
    stream.reset_launch_count()
    with spy(stream, "idg_aw_grid_from_records_stream", calls):
        img, nd = step(uvw_t, C, vis_t, a1, a2, scr)
        torch.cuda.synchronize()
    launches = stream.launch_count(stream.GRID_KERNEL)
    ref, _, nd_ref = ds.aw_idg_pipeline(scr, uvw_t, a1, a2, f_t, vis_t,
                                        theta=THETA, lam=LAM,
                                        subgrid=SUBGRID, taper_beta=BETA,
                                        max_runs=mr)
    img, ref = img.cpu().numpy(), ref.cpu().numpy()
    err = rel_l2(crop75(img), crop75(ref))
    print(f"sharded IDG-AW step ({t.n} track records, 64 stations, random "
          f"15² A-kernels, S={SUBGRID}, max_runs {mr}): dropped {int(nd)} "
          f"(unsharded {int(nd_ref)}); image vs the unsharded chain on the "
          f"card rel-L2 {err:.3e} over the central 75% (bound {IMAGE_TOL}); "
          f"idg_grid launches {launches}")
    phase_line("sharded IDG-AW step", wall_ms(torch, lambda: step(
        uvw_t, C, vis_t, a1, a2, scr), reps=3), launches)
    if int(nd) != 0 or int(nd_ref) != 0 or launches != 1:
        raise AssertionError(f"sharded IDG-AW: dropped {int(nd)}, "
                             f"{launches} launches")
    if not (np.isfinite(img).all() and err <= IMAGE_TOL):
        raise AssertionError(f"sharded IDG-AW image: {err}")
    entries.append(stream_grid_entry(torch, card, "sharded IDG-AW",
                                     calls[0], launches, t.n))
    del t, uvw_t, vis_t, a1, a2, calls

    # ---- 35. the sharded cube core on the cube observation -----------------
    _, vd_c = cube_observation()
    nch = vd_c.frequencies.shape[0]
    cube_kw = dict(theta=THETA, lam=LAM, subgrid=SUBGRID, taper_beta=BETA)
    stream.reset_launch_count()
    res = sp.idg_cube_sharded(vd_c, mesh, **cube_kw)
    torch.cuda.synchronize()
    launches = stream.launch_count(stream.GRID_KERNEL)
    with plain_kernels(torch):
        ref = sp.idg_cube_sharded(vd_c, mesh, **cube_kw)
    local = sp.idg_cube(vd_c, device=dev, **cube_kw)
    cube, ref_c = res.cube.cpu().numpy(), ref.cube.cpu().numpy()
    loc = local.cube.cpu().numpy()
    errs = [rel_l2(crop75(cube[c]), crop75(ref_c[c])) for c in range(nch)]
    far = [rel_l2(crop75(cube[c]), crop75(loc[c])) for c in range(nch)]
    n_c = vd_c.uvw.shape[0]
    print(f"sharded cube core (idg_cube_sharded, {nch} channels x {n_c} "
          f"records = {nch * n_c} channel-vis, S={SUBGRID}): groups "
          f"{[(i, j) for i, j, _, _ in res.groups]}, idg_grid launches "
          f"{launches} (expected {nch}); vs the same core on the plain "
          f"kernels rel-L2 max {max(errs):.3e} over the central 75% (bound "
          f"{IMAGE_TOL}); vs idg_cube (no bound: exact per-channel "
          f"coordinates against shared binning) max {max(far):.3e}")
    phase_line("sharded cube core", wall_ms(torch, lambda: sp.idg_cube_sharded(
        vd_c, mesh, **cube_kw), reps=3), launches)
    if launches != nch or not np.isfinite(cube).all():
        raise AssertionError(f"sharded cube: {launches} launches")
    if not max(errs) <= IMAGE_TOL:
        raise AssertionError(f"sharded cube parity: {errs}")
    return entries


# ---- phases 36-38: the last modules of the reference ------------------------
FORMATS = ("posit16", "bf16", "f8_e4m3", "f8_e5m2")


def lowprec_sample(n: int, seed: int) -> np.ndarray:
    """Phase 36's ``n`` float32s: normal values scaled by 2^U(-40, 40)
    (the posit range, 2^±28, and beyond), raw 32-bit patterns (NaN
    payloads, ±inf, subnormals among them), explicit subnormals, and
    zeros, ±inf, NaNs and the float8 overflow values."""
    rng = np.random.default_rng(seed)
    fixed = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45,
                      448.0, 463.99, 464.0, 465.0, -500.0, 57344.0, 61440.0,
                      61441.0, 2.0 ** 28, 2.0 ** -28, 1e30, -1e-30],
                     np.float32)
    n_spread, n_raw = n // 2, n // 4
    n_sub = n - n_spread - n_raw - fixed.size
    return np.concatenate([
        (rng.standard_normal(n_spread)
         * np.exp2(rng.uniform(-40, 40, n_spread))).astype(np.float32),
        rng.integers(0, 2 ** 32, n_raw, dtype=np.uint64).astype(
            np.uint32).view(np.float32),
        (rng.uniform(-1, 1, n_sub) * 1.17e-38).astype(np.float32),
        fixed])


def edge_phases(torch, dev, card, vd, obs):
    """Phases 36-38 on the main path's observation ``vd``/``obs``.
    Returns the entries of the ``kernels`` line of the kernels they
    launch."""
    entries = lowprec_phase(torch, dev, card)
    entries += cross_method_phase(torch, dev, card, vd, obs)
    entries += hdf5_phase(torch, dev, card, vd, obs)
    return entries


def lowprec_phase(torch, dev, card):
    """Phase 36: the posit16 codec and the quantizers on the card against
    the CPU, and the quantization study through ``csrc/wproj_grid.cu``."""
    from ska_sdp_tpu_torch.kernels import wproj
    from ska_sdp_tpu_torch.ops import lowprec, mirror_uvw
    from ska_sdp_tpu_torch.ops.search import find_closest

    def n_differ(a, b) -> int:
        """Elements whose 32-bit patterns differ (complex: per part)."""
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        a, b = a.cpu().contiguous(), b.contiguous()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return int((a != b).sum())

    # ---- 36a. the codec and the quantizers, bit for bit ---------------------
    pats = torch.arange(65536, dtype=torch.int32)
    dec = lowprec.p16_to_f32(pats.to(dev))
    back = lowprec.f32_to_p16(dec)
    torch.cuda.synchronize()
    bad_dec = n_differ(dec, lowprec.p16_to_f32(pats))
    bad_back = int(((back.cpu() & 0xFFFF) != pats).sum())
    x = torch.from_numpy(lowprec_sample(1 << 22, 36))
    bad_enc = n_differ(lowprec.f32_to_p16(x.to(dev)), lowprec.f32_to_p16(x))
    print(f"posit16 on the card: 65,536 patterns decoded, {bad_dec} differ "
          f"from the CPU's bits; encoded back, {bad_back} differ from the "
          f"pattern; {x.numel():,} sampled float32s (zeros, subnormals, "
          f"±inf, NaNs, raw bit patterns) encoded, {bad_enc} differ from "
          f"the CPU's (bound 0 each)")
    if bad_dec or bad_back or bad_enc:
        raise AssertionError("the posit16 codec on the card is not the "
                             "CPU's bit for bit")
    c = torch.complex(x, x.flip(0))
    for name in FORMATS:
        q = lowprec.QUANTIZERS[name]
        bad = n_differ(q(c.to(dev)), q(c))
        print(f"  quantizer {name} on {c.numel():,} complex64 values: "
              f"{bad} parts differ from the CPU's bits (bound 0)")
        if bad:
            raise AssertionError(f"{name} on the card differs from the CPU")
    e4 = lowprec.quantize_f8(torch.tensor([464.0, 465.0, -500.0,
                                           float("inf")], device=dev))
    print(f"  e4m3 overflow on the card: 464 -> {e4[0].item()}, 465, -500, "
          f"inf -> {e4[1:].tolist()}")
    if e4[0].item() != 448.0 or not torch.isnan(e4[1:]).all():
        raise AssertionError("e4m3 overflow is not the reference's")

    # ---- 36b. the quantization study at the bank benchmark's shape ---------
    b = bench_records()
    bank, centers, uvw, vis = (torch.as_tensor(b[k], device=dev) for k in
                               ("bank", "centers", "uvw", "vis"))
    uvw1, vis1 = mirror_uvw(uvw, vis)
    wbin = find_closest(centers, uvw1[:, 2])
    p = uvw1 / LAM
    shape = tuple(b["grid"].shape)

    def study():
        return lowprec.gridding_quantization_error(bank, p, wbin, vis1,
                                                   shape, formats=FORMATS)

    calls = []
    wproj.reset_launch_count()
    with spy(wproj, "wproj_gridder", calls):
        errs = study()
        torch.cuda.synchronize()
    launches = wproj.launch_count(wproj.GRID_KERNEL)
    t = wall_ms(torch, study, reps=3)
    print(f"quantization study (gridding_quantization_error, {p.shape[0]} "
          f"records, NW=32, QPX=8, 15², {shape[0]}²): rel RMS grid error "
          + ", ".join(f"{k} {v:.4e}" for k, v in errs.items())
          + f"; wproj_grid launches {launches} (expected 5); {t:.3f} ms "
          f"(median of 3) [{card}]")
    if launches != 1 + len(FORMATS) or len(calls) != launches:
        raise AssertionError(f"quantization study: {launches} launches")
    if not all(np.isfinite(v) for v in errs.values()):
        raise AssertionError(f"quantization study errors: {errs}")
    return [scatter_entry(torch, card, f"quantization study {name}", call,
                          launches)
            for name, call in zip(FORMATS, calls[1:])]


def corrected_image(torch, grid, S):
    """The centred inverse FFT of a grid divided by IDG's fine taper at
    subgrid ``S`` (numpy, complex128)."""
    from ska_sdp_tpu_torch.ops import ifft_centered
    from ska_sdp_tpu_torch.ops.idg import kaiser_taper, taper_fine

    n = grid.shape[0]
    tf = taper_fine(n, S, kaiser_taper(S, BETA, device=grid.device))
    img = ifft_centered(grid.to(torch.complex128)) / torch.outer(tf, tf)
    return img.cpu().numpy()


def cross_method_phase(torch, dev, card, vd, obs):
    """Phase 37: IDG against the bank scatter and IDG-AW against the AW
    scatter, the scatters fed with the tapered bank."""
    from ska_sdp_tpu_torch import kernels
    from ska_sdp_tpu_torch.config import KernelOptions
    from ska_sdp_tpu_torch.kernels import aw_fused, wproj
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.ops.idg import tapered_w_bank
    from ska_sdp_tpu_torch.ops.idg_aw import aw_screens_host
    from ska_sdp_tpu_torch.ops.search import find_closest

    opts = KernelOptions(qpx=8, npix_ff=256, npix_kern=SUPPORT)
    entries = []

    def lattice(p, n):
        """uv snapped to the qpx=8 oversampling lattice of an n² grid."""
        return torch.cat([torch.round(p[:, :2] * (8 * n)) / (8 * n),
                          p[:, 2:]], 1)

    def compare(label, g_idg, g_ref, nd, counts):
        err = rel_l2(crop75(corrected_image(torch, g_idg, SUBGRID)),
                     crop75(corrected_image(torch, g_ref, SUBGRID)))
        print(f"  {label}: taper-corrected images rel-L2 {err:.3e} over the "
              f"central 75% (bound {CROSS_TOL}); dropped {nd}; launches "
              + ", ".join(f"{k} {v}" for k, v in counts.items()))
        if nd != 0 or any(v != 1 for v in counts.values()):
            raise AssertionError(f"{label}: dropped {nd}, launches {counts}")
        if not err <= CROSS_TOL:
            raise AssertionError(f"{label}: rel-L2 {err}")

    # ---- 37a. IDG against the bank scatter on the main path ---------------
    centers, _ = w_bank_inputs(torch, obs, dev)
    cent = torch.as_tensor(centers, device=dev)
    bank_t = tapered_w_bank(THETA, cent, opts, BETA, SUBGRID,
                            device=dev).to(torch.complex64)
    uvw, f, vis = ds.idg_inputs(vd, device=dev)
    g = ds.idg_grid_inputs(uvw, f, vis, theta=THETA, lam=LAM)
    p = lattice(g.p, g.grid_shape[0])
    wbin = find_closest(cent.float(), g.w)
    w_b = cent.float()[wbin.long()]
    calls_w, calls_i = [], []
    wproj.reset_launch_count()
    stream.reset_launch_count()
    with spy(wproj, "wproj_gridder", calls_w), \
            spy(stream, "idg_aw_grid_from_records_stream", calls_i):
        g_bank = wproj.wproj_gridder(bank_t, g.grid_shape, p, wbin, g.vis)
        g_idg, nd = kernels.idg_gridder(g.grid_shape, p, w_b, g.vis,
                                        theta=THETA, subgrid=SUBGRID,
                                        taper_beta=BETA)
        torch.cuda.synchronize()
    counts = {"wproj_grid": wproj.launch_count(wproj.GRID_KERNEL),
              "idg_grid": stream.launch_count(stream.GRID_KERNEL)}
    print(f"cross-method IDG (S={SUBGRID}, β={BETA}) against the bank "
          f"scatter on tapered_w_bank ({len(centers)} planes, qpx=8, 15²), "
          f"phase 4's {g.p.shape[0]} records on the qpx=8 lattice, w at its "
          f"plane [{card}]:")
    compare("IDG vs tapered bank scatter", g_idg, g_bank, int(nd), counts)
    entries.append(scatter_entry(torch, card, "tapered bank",
                                 calls_w[0], counts["wproj_grid"]))
    entries.append(stream_grid_entry(torch, card, "cross-method IDG",
                                     calls_i[0], counts["idg_grid"],
                                     g.p.shape[0]))
    del g, g_bank, g_idg, calls_w, calls_i, bank_t

    # ---- 37b. IDG-AW against the AW scatter on the track shape ------------
    t = aw_track_inputs()
    rng = np.random.default_rng(37)
    ak = np.zeros((t.nant, SUPPORT, SUPPORT), np.complex128)
    c = SUPPORT // 2
    ak[:, c, c] = 1.0
    ak[:, c - 1:c + 2, c - 1:c + 2] += 0.05 * (
        rng.standard_normal((t.nant, 3, 3))
        + 1j * rng.standard_normal((t.nant, 3, 3)))
    n = int(round(THETA * LAM))
    shape = (n, n)
    uvw_t, f_t, vis_t = ds.idg_inputs(t.vd, device=dev)
    p_t = lattice(uvw_t / LAM, n).float()
    w_t = uvw_t[:, 2].float()
    cent_t = torch.linspace(float(w_t.min()), float(w_t.max()), 32,
                            dtype=torch.float64, device=dev)
    wbin_t = find_closest(cent_t.float(), w_t)
    a1 = torch.as_tensor(t.a1.astype(np.int32), device=dev)
    a2 = torch.as_tensor(t.a2.astype(np.int32), device=dev)
    bank_c = torch.conj(tapered_w_bank(THETA, cent_t, opts, BETA, SUBGRID,
                                       device=dev)).to(torch.complex64)
    scr = torch.as_tensor(aw_screens_host(ak, SUBGRID), dtype=torch.complex64,
                          device=dev)
    ak64 = torch.as_tensor(ak, dtype=torch.complex64, device=dev)
    mr = ds.aw_run_bound(t.a1, t.a2, t.n)
    calls_a, calls_i = [], []
    aw_fused.reset_launch_count()
    stream.reset_launch_count()
    with spy(aw_fused, "aw_fused_grid", calls_a), \
            spy(stream, "idg_aw_grid_from_records_stream", calls_i):
        g_aw = kernels.aw_gridder(bank_c, ak64, torch.zeros(
            shape, dtype=torch.complex64, device=dev), p_t, wbin_t, a1, a2,
            vis_t)
        g_idg, nd = kernels.idg_aw_gridder(
            shape, p_t, a1, a2, cent_t.float()[wbin_t.long()], vis_t, scr,
            theta=THETA, subgrid=SUBGRID, taper_beta=BETA, max_runs=mr)
        torch.cuda.synchronize()
    counts = {"aw_grid": aw_fused.launch_count(aw_fused.GRID_KERNEL),
              "idg_grid": stream.launch_count(stream.GRID_KERNEL)}
    print(f"cross-method IDG-AW (S={SUBGRID}, {t.nant} stations, near-delta "
          f"15² A-kernels, max_runs {mr}) against the AW scatter on the "
          f"conjugated tapered bank (32 planes over w in "
          f"[{float(w_t.min()):.1f}, {float(w_t.max()):.1f}] λ), the track "
          f"shape's {t.n} records on the qpx=8 lattice [{card}]:")
    compare("IDG-AW vs AW scatter", g_idg, g_aw, int(nd), counts)
    entries.append(aw_entry(torch, card, "cross-method AW", calls_a[0],
                            counts["aw_grid"]))
    entries.append(stream_grid_entry(torch, card, "cross-method IDG-AW",
                                     calls_i[0], counts["idg_grid"], t.n))
    return entries


def idg_cycle_records(torch, dev, seed: int = 0):
    """The benchmark cell ``idg.cycle``'s run tables at its own 3888²
    shape: the SKA1-Low snapshot of ``benchmark/configs/ska1low-idg.json``
    (1,046,528 records) from ``benchmark/observation.py`` at ``seed``, sky
    0, through the entries' preps (``idg_image``'s weighted mirrored
    records and ``idg_predict_vis``'s records of the sky's snapped model).
    Returns ``(grid_args, degrid_args, settings)``: the first seven
    arguments of ``idg_aw_grid_from_records_stream`` and
    ``idg_aw_degrid_from_records_stream`` and the two calls' keywords."""
    from benchmark import observation as obsgen
    from ska_sdp_tpu_torch.io.inputs import VisData
    from ska_sdp_tpu_torch.kernels import _idg_unit_run_bound
    from ska_sdp_tpu_torch.kernels.idg_aw_records import (
        idg_aw_degrid_records, idg_aw_run_records)
    from ska_sdp_tpu_torch.models import dataset as ds

    def config(*path):
        with open(os.path.join(HERE, "benchmark", *path)) as fh:
            return json.load(fh)

    cfg = config("configs", "ska1low-idg.json")
    mix = config("mixes", "idg.cycle.json")
    st = cfg["settings"]
    S, support, theta, lam = (st["subgrid"], st["support"], st["theta"],
                              st["lam"])
    ocfg = obsgen.from_config(cfg, mix["sky"]["sources"], seed)
    obs = obsgen.simulate_observation(ocfg)
    src, vis = obsgen.sky(obs, ocfg, 0, dev)
    vd = VisData(vis, obs["uvw"], obs["antenna1"], obs["antenna2"],
                 obs["time"], float(obs["frequency"][0]))
    uvw, f, v = ds.idg_inputs(vd, device=dev)
    g = ds.idg_grid_inputs(uvw, f, v, theta=theta, lam=lam)
    zer = torch.zeros((g.p.shape[0],), dtype=torch.int32, device=dev)
    grid_args = idg_aw_run_records(
        g.grid_shape, g.p, zer, zer, g.w, g.vis.real, g.vis.imag,
        subgrid=S, support=support,
        max_runs=_idg_unit_run_bound(g.grid_shape, S, support), nant=1)[:7]
    n = int(round(theta * lam))
    model = torch.as_tensor(obsgen.snapped_model(src, n, lam),
                            dtype=torch.float32, device=dev)
    d = ds.degrid_inputs(model, uvw, f, theta=theta, lam=lam, subgrid=S,
                         taper_beta=st["taper_beta"])
    shape = tuple(d.grid.shape)
    zer = torch.zeros((d.p.shape[0],), dtype=torch.int32, device=dev)
    degrid_args = idg_aw_degrid_records(
        shape, d.p, zer, zer, d.w, subgrid=S, support=support,
        max_runs=_idg_unit_run_bound(shape, S, support))[:7]
    unit = torch.ones((1, S, S), dtype=torch.complex64, device=dev)
    kw = dict(subgrid=S, taper_beta=st["taper_beta"])
    return (grid_args, degrid_args,
            dict(grid=dict(grid_shape=g.grid_shape, screens=unit,
                           theta=g.theta, **kw),
                 degrid=dict(grid=d.grid, screens=unit, theta=d.theta,
                             **kw)))


def crowded_phase(torch, dev, card, seed: int = 0):
    """Phase 39: #1 and #2 alone on ``idg.cycle``'s crowded SKA1-Low core
    (:func:`idg_cycle_records`): the run table's longest runs and their
    share, the kernels' work items, each kernel's time (CUDA events,
    median of 7) beside its plain version's result and the split counts
    the kernel made against those its plain items give."""
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.ops.idg_aw import PAIR_SHIFT
    from ska_sdp_tpu_torch.utils import timing

    grid_args, degrid_args, kw = idg_cycle_records(torch, dev, seed)
    S = kw["grid"]["subgrid"]
    n_rec = int(grid_args[0].shape[1])
    m = (grid_args[2] - grid_args[1]).long()
    m = torch.sort(m[m > 0], descending=True).values
    share = [float(m[:k].sum()) / float(m.sum()) for k in (1, 5, 20)]
    print(f"idg.cycle's core (seed {seed}, {n_rec} records, S={S}): "
          f"{m.numel()} occupied runs, longest {int(m[0])}, median "
          f"{int(m[m.numel() // 2])}; the longest 1 / 5 / 20 hold "
          f"{share[0]:.1%} / {share[1]:.1%} / {share[2]:.1%} of the records "
          f"[{card}]")

    def grid():
        return stream.idg_aw_grid_from_records_stream(
            *grid_args, kw["grid"]["grid_shape"], kw["grid"]["screens"],
            theta=kw["grid"]["theta"], subgrid=S,
            taper_beta=kw["grid"]["taper_beta"])

    def degrid():
        return stream.idg_aw_degrid_from_records_stream(
            *degrid_args, kw["degrid"]["grid"], kw["degrid"]["screens"],
            theta=kw["degrid"]["theta"], subgrid=S,
            taper_beta=kw["degrid"]["taper_beta"])

    shape = kw["grid"]["grid_shape"]
    N, Nx = shape
    plain_g = stream.grid_from_records_plain(
        *grid_args, kw["grid"]["screens"], grid_shape=shape,
        theta=kw["grid"]["theta"], subgrid=S,
        taper_beta=kw["grid"]["taper_beta"])[S:S + N, S:S + Nx]
    plain_d = stream.degrid_from_records_plain(
        *degrid_args, kw["degrid"]["grid"], kw["degrid"]["screens"],
        theta=kw["degrid"]["theta"], subgrid=S,
        taper_beta=kw["degrid"]["taper_beta"])
    for label, fn, plain, args, kernel in (
            ("#1 idg_grid", grid, plain_g, grid_args, stream.GRID_KERNEL),
            ("#2 idg_degrid", degrid, plain_d, degrid_args,
             stream.DEGRID_KERNEL)):
        starts, ends = args[1], args[2]
        if kernel == stream.DEGRID_KERNEL:       # starts_ext, sentinels
            starts = args[1][:-1]
            ends = torch.where(args[4] < PAIR_SHIFT,
                               torch.clamp(args[1][1:], max=n_rec), starts)
        resident = stream.resident_blocks(kernel, S)
        run, _, _ = stream.run_items(starts, ends, int(args[0].shape[1]),
                                     resident, S)
        want = stream.split_counts(run)
        timing.COUNTERS.reset("split/")
        out = fn()
        torch.cuda.synchronize()
        timing.settle_counts()
        key = "idg_grid" if kernel == stream.GRID_KERNEL else "idg_degrid"
        got = timing.COUNTERS.group(f"split/{key}/")
        err = rel_l2(out.cpu().numpy(), plain.cpu().numpy())
        ms = timed_ms(torch, fn)
        print(f"  {label}: {ms:.3f} ms (median of {REPS}); {resident} "
              f"resident blocks, items of L = "
              f"{stream.item_length(int(args[0].shape[1]), resident, S)}: "
              f"{run.numel()} items, {want[0]} runs split into {want[1]}; "
              f"the kernel counted {got}; rel-L2 {err:.2e} from the plain "
              f"version [{card}]")
        if got != {"runs": want[0], "items": want[1]}:
            raise AssertionError(f"{label}: split counts {got}, plain "
                                 f"items {want}")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{label}: rel-L2 {err}")


def crowded_main() -> int:
    """``--crowded``: phase 39 alone, after phases 1 and 2 of the IDG
    kernels."""
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device visible; this smoke test runs only on "
              "a GPU", file=sys.stderr)
        return 1
    from ska_sdp_tpu_torch.kernels import _build

    card = smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    for k in ("idg_grid", "idg_degrid"):
        t = time.perf_counter()
        _build.load(k)
        print(f"build: {k}.cu for sm_90a in {time.perf_counter() - t:.1f} s")
        print_ptxas(_build.build_log, k, padded=False)
    crowded_phase(torch, torch.device("cuda", 0), card)
    print(card)
    return 0


SYNTH_TOL = {"complex64": 2e-6, "complex128": 1e-12}


def synth_flop(nw, n0, rows):
    """The pruned transform's operations: ``n0·rows·n0`` complex
    multiply-adds along x and ``rows·rows·n0`` along y a plane, 8 each."""
    return 8 * nw * (n0 * rows * n0 + rows * rows * n0)


def synth_phase(torch, dev, card):
    """Phase 40: ``csrc/wkernel_synth.cu`` on ``wcache.psf``'s bank (33
    planes over ±1,920 λ at θ = 0.054, 256/8/15) in complex64 and
    complex128: parity with the plain version and with the padded
    transform on the card, the conjugation flag, each timed (median of 7)
    beside the bound, printed (the ``kernels`` line takes the kernel's
    entries from the main path, phase 27)."""
    from ska_sdp_tpu_torch.config import KernelOptions
    from ska_sdp_tpu_torch.kernels import wkernel_synth as synth
    from ska_sdp_tpu_torch.ops.fourier import ifft_centered, pad_mid
    from ska_sdp_tpu_torch.ops.wkernel import (extract_oversampled,
                                               kernel_coordinates,
                                               w_kernel_function,
                                               w_kernel_taps_plain)

    opts = KernelOptions(qpx=8, npix_ff=256, npix_kern=15)
    n0, qpx, s = opts.npix_ff, opts.qpx, opts.npix_kern
    centres = -1920.0 + 120.0 * np.arange(33)
    for real in (torch.float32, torch.float64):
        l, m = kernel_coordinates(n0, 0.054, opts, dtype=real, device=dev)
        scr = w_kernel_function(l, m, torch.as_tensor(centres, dtype=real,
                                                      device=dev))
        synth.reset_launch_count()
        got = synth.wkernel_synth(scr, qpx, s)
        got_c = synth.wkernel_synth(scr, qpx, s, conj=True)
        torch.cuda.synchronize()
        launches = synth.launch_count()

        def library():
            return extract_oversampled(ifft_centered(pad_mid(scr, n0 * qpx)),
                                       qpx, s)
        plain = w_kernel_taps_plain(scr, qpx, s)
        lib = library()
        g = got.cpu().numpy()
        err_p = rel_l2(g, plain.cpu().numpy())
        err_l = rel_l2(g, lib.cpu().numpy())
        max_abs = float(np.abs(g - lib.cpu().numpy()).max())
        conj_ok = torch.equal(got_c, got.conj().resolve_conj())
        tol = SYNTH_TOL[str(scr.dtype).split(".")[-1]]
        ms = timed_ms(torch, lambda: synth.wkernel_synth(scr, qpx, s))
        ms_plain = timed_ms(torch, lambda: w_kernel_taps_plain(scr, qpx, s))
        ms_lib = timed_ms(torch, library)
        nw = scr.shape[0]
        flop = synth_flop(nw, n0, qpx * s)
        bound_ms, bound_by = bound(flop, nbytes(scr, got))
        print(f"w-kernel synthesis, {scr.dtype} ({nw} planes, {n0}² screens,"
              f" qpx {qpx}, support {s}; {flop / 1e9:.2f} GFLOP): kernel "
              f"{ms:.3f} ms, plain {ms_plain:.3f} ms, pad + cuFFT "
              f"(library_ms) {ms_lib:.3f} ms; bound {bound_ms:.4f} ms "
              f"({bound_by}); "
              f"rel-L2 {err_p:.2e} from the plain version, {err_l:.2e} from "
              f"pad + cuFFT (bound {tol}), max |err| {max_abs:.2e}; "
              f"conjugated taps equal: {conj_ok}; launches/wkernel_synth "
              f"{launches} [{card}]")
        if not (err_p <= tol and err_l <= tol and conj_ok and launches == 2):
            raise AssertionError(f"w-kernel synthesis ({scr.dtype}): "
                                 f"{err_p}, {err_l}, {conj_ok}, {launches}")


def synth_main() -> int:
    """``--synth``: phase 40 alone, after building its kernel."""
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device visible; this smoke test runs only on "
              "a GPU", file=sys.stderr)
        return 1
    from ska_sdp_tpu_torch.kernels import _build

    card = smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    t = time.perf_counter()
    _build.load("wkernel_synth")
    print(f"build: wkernel_synth.cu for sm_90a in "
          f"{time.perf_counter() - t:.1f} s")
    print_ptxas(_build.build_log, "wkernel_synth")
    synth_phase(torch, torch.device("cuda", 0), card)
    print(card)
    return 0


def hdf5_phase(torch, dev, card, vd, obs):
    """Phase 38: the CLI's ``--mode idg`` file entry on the card through
    the native HDF5 backend, where the card's machine has an HDF5 1.10
    runtime."""
    import shutil
    import tempfile

    from ska_sdp_tpu_torch import cli
    from ska_sdp_tpu_torch.io import h5, native_backend, schema
    from ska_sdp_tpu_torch.io.native import build
    from ska_sdp_tpu_torch.io.synthetic import write_vis_file
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.models import dataset as ds

    rt = build.find_hdf5()
    if rt.path is None:
        print(f"HDF5 on the card: not run, {build.describe(rt)}")
        return []
    t0 = time.perf_counter()
    native_backend.ensure_loaded()
    print(f"HDF5 on the card: {build.describe(rt)}; native library built "
          f"and loaded in {time.perf_counter() - t0:.1f} s")
    work = tempfile.mkdtemp(dir=os.path.join(HERE, "ska_sdp_tpu_torch",
                                             "io", "native", "build"))
    saved = os.environ.get("SKA_SDP_TPU_H5_BACKEND")
    os.environ["SKA_SDP_TPU_H5_BACKEND"] = "native"
    try:
        if h5.backend_name() != "native":
            raise AssertionError("the façade did not select the native "
                                 "backend")
        t0 = time.perf_counter()
        write_vis_file(os.path.join(work, "vis.h5"), obs)
        t_write = (time.perf_counter() - t0) * 1e3
        out = os.path.join(work, "img.h5")
        calls, log = [], io.StringIO()
        stream.reset_launch_count()
        with spy(stream, "idg_aw_grid_from_records_stream", calls), \
                contextlib.redirect_stdout(log):
            rc = cli.main(["--mode", "idg", "-i", work, "--all", "--theta",
                           str(THETA), "--lam", str(LAM), "-o", out,
                           "-dphases", "--device", dev.type])
        torch.cuda.synchronize()
        launches = stream.launch_count(stream.GRID_KERNEL)
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}:\n"
                                 f"{log.getvalue()}")
        t0 = time.perf_counter()
        img = h5.read_dataset(out, schema.IMG_DATASET)
        t_read = (time.perf_counter() - t0) * 1e3
    finally:
        if saved is None:
            os.environ.pop("SKA_SDP_TPU_H5_BACKEND")
        else:
            os.environ["SKA_SDP_TPU_H5_BACKEND"] = saved
        shutil.rmtree(work)
    n_vis = vd.vis.shape[0]
    print(f"  io/synthetic wrote phase 4's observation ({n_vis} vis) in "
          f"{t_write:.1f} ms; cli.main --mode idg -o -dphases on the card: "
          f"idg_grid launches {launches}, its output:")
    for line in log.getvalue().splitlines():
        print(f"    {line}")
    ref = ds.idg_image(vd, theta=THETA, lam=LAM, subgrid=SUBGRID,
                       taper_beta=BETA, device=dev).image.cpu().numpy()
    err = rel_l2(crop75(img), crop75(ref))
    print(f"  /img read back ({img.shape}, {img.dtype}) in {t_read:.1f} ms: "
          f"vs idg_image on the same arrays rel-L2 {err:.3e} over the "
          f"central 75% (bound {FILE_TOL}) [{card}]")
    if launches < 1 or not np.isfinite(img).all():
        raise AssertionError(f"file entry: {launches} launches")
    if not err <= FILE_TOL:
        raise AssertionError(f"file entry image: {err}")
    return [stream_grid_entry(torch, card, "--mode idg file entry", calls[0],
                              launches, n_vis)]


if __name__ == "__main__":
    sys.exit({"--crowded": crowded_main, "--synth": synth_main}.get(
        " ".join(sys.argv[1:]), main)())
