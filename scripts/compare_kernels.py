#!/usr/bin/env python3
"""Time the streamed IDG gridder and degridder, the fixed-tile IDG route,
the bank w-projection scatter and gather and the fused AW gridder of this
checkout against those of another checkout, in one process on one NVIDIA
GPU, in turns.

    python3 scripts/compare_kernels.py --other DIR [--reps 7] [--only NAME...]

``DIR`` holds a checkout of another commit; its ``ska_sdp_tpu_torch/``
package is loaded under another name and builds its CUDA kernels into its
own ``build/``.  At ``chip_smoke.py``'s shapes, both versions of each
wrapper get the same inputs: ``wproj_gridder`` at the reference
benchmark's bank shape (phase 12b: 1,048,576 records, NW=32, QPX=8, 15²,
2400²), on ``w_image``'s records of the 512-station observation, and on
one channel of the cube observation (phase 24, channel 0 as ``w_image``
takes it); ``aw_fused_grid`` at the benchmark's fused-AW shape (phase 16b:
524,288 records, 64 stations) and at the main path's 512 stations (16d:
1,046,528 records); ``idg_aw_grid_from_records_stream`` (``idg_grid``) on
the main path's records at S=64 (phase 3b, unit screens), on channel 0 of
the cube observation through the IDG prep and through the IDG-AW cube
raster's ordered prep (phase 25), at the IDG-AW track shape with random
screens (phase 9) and on the benchmark cell ``idg.cycle``'s crowded
3888² run table (phase 39), each with its run table's longest and mean
run; ``idg_aw_degrid_from_records_stream`` (``idg_degrid``) on the main
path's degrid records at S=64 (phase 7b, unit screens) and at the IDG-AW
track shape (phase 9, random screens), each degridding a random 2400²
grid, and on ``idg.cycle``'s predict table and model grid (phase 39);
``wproj_degridder`` (``wproj_degrid``) at the bank benchmark's shape
(phase 12b, its random grid) and on ``w_predict_vis``'s records of the
512-station observation (the raw bank, a random grid).  The fixed-tile
route's public ``idg_tile.idg_grid_from_records`` and
``idg_degrid_from_records`` (``idg_tile``; the degridder with whatever
runs before its kernel, such as window sandwiches) at S=32 on the main
path's records (phases 20b and 22; the degridder on phase 8's kind of
model, a random grid here), on channel 0 of the cube observation (the
multi prep at S=32, as ``idg_cube`` grids it, and that channel's
degrid prep) and at 512² with S=48 (phase 20a's records).  ``--only``
keeps the shapes of the kernels it names (``idg_grid``, ``idg_degrid``,
``idg_tile``, ``wproj_grid``, ``wproj_degrid``, ``aw_grid``) and builds
only their inputs.  Per shape
the two results are compared (rel-L2), then each wrapper is timed with
CUDA events (median of ``--reps`` after a warm-up, its prep included) in
the order other, this, this, other, and its device time per call is read
from ``torch.profiler`` over ``--reps`` calls (the sum of its kernels,
copies and memsets: what the card spends, where the wrapper's time also
holds the host's).  It prints the card's name and power limit, then one
JSON line per shape with both pairs of times.  It needs a CUDA card and
stops without one.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def load_other(root: str):
    """The other checkout's ``(aw_fused, wproj, idg_aw_stream, idg_tile)``
    kernel modules."""
    pkg = os.path.join(os.path.abspath(root), "ska_sdp_tpu_torch")
    name = "other_ska_sdp_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.kernels.{k}")
                 for k in ("aw_fused", "wproj", "idg_aw_stream",
                           "idg_tile"))


def bank_aw_cases(torch, dev):
    """The bank scatter's and the fused AW gridder's shapes: ``(label,
    records, call)`` with ``call(module)`` the wrapper's grid."""
    import numpy as np
    from chip_smoke import (LAM, THETA, bench_records, cube_observation,
                            main_akerns, main_observation, w_bank_inputs)
    from ska_sdp_tpu_torch.kernels import aw_fused
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.ops import doweight, mirror_uvw, uvw_lambda
    from ska_sdp_tpu_torch.ops.search import find_closest

    def to_dev(*arrays):
        return [torch.as_tensor(a, device=dev) for a in arrays]

    cases = []
    # the benchmark's bank shape (phase 12b) and fused-AW shape (16b)
    b = bench_records()
    bank_b, centers_b, uvw_b, vis_b = to_dev(b["bank"], b["centers"],
                                             b["uvw"], b["vis"])
    uvw1, vis1 = mirror_uvw(uvw_b, vis_b)
    wbin_b = find_closest(centers_b, uvw1[:, 2])
    n_grid = int(round(THETA * LAM))
    shape = (n_grid, n_grid)
    cases.append(("wproj_grid, bench shape", vis1.shape[0],
                  lambda m: m.wproj_gridder(bank_b, shape, uvw1 / LAM,
                                            wbin_b, vis1)))
    n_b = 1 << 19
    rng = np.random.default_rng(1)
    ak_b, a1_b, a2_b = to_dev(
        (rng.standard_normal((64, 15, 15))
         + 1j * rng.standard_normal((64, 15, 15))).astype(np.complex64),
        rng.integers(0, 64, n_b).astype(np.int32),
        rng.integers(0, 64, n_b).astype(np.int32))
    u_aw, v_aw = mirror_uvw(uvw_b[:n_b], vis_b[:n_b])
    rec_b, pt_b, ws_b = aw_fused.aw_records_tables(
        bank_b, ak_b, shape, u_aw / LAM, find_closest(centers_b, u_aw[:, 2]),
        a1_b, a2_b)
    cases.append(("aw_grid, bench shape", n_b,
                  lambda m: m.aw_fused_grid(pt_b, ws_b, rec_b, v_aw, shape)))

    # the main path's records (w_image, and aw_image's 512 stations)
    obs, vd = main_observation()
    centers, build_bank = w_bank_inputs(torch, obs, dev)
    bank = build_bank().to(torch.complex64)
    bank_conj = torch.conj(bank).resolve_conj()
    cent32 = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    uvw, f, vis = ds.idg_inputs(vd, device=dev)
    g = ds.idg_grid_inputs(uvw, f, vis, theta=THETA, lam=LAM)
    wbin = find_closest(cent32, g.w)
    cases.append(("wproj_grid, w_image records", g.vis.shape[0],
                  lambda m: m.wproj_gridder(bank_conj, g.grid_shape, g.p,
                                            wbin, g.vis)))
    a1, a2 = to_dev(vd.antenna1.astype(np.int32),
                    vd.antenna2.astype(np.int32))
    ak = torch.as_tensor(main_akerns(), dtype=torch.complex64, device=dev)
    # aw_image's records: weighted, mirrored, the raw bank
    uvw0 = uvw_lambda(f, uvw)
    wt = doweight(THETA, LAM, uvw0, torch.ones_like(vis))
    u_m, v_m = mirror_uvw(uvw0, vis)
    rec_d, pt_d, ws_d = aw_fused.aw_records_tables(
        bank, ak, shape, u_m / LAM, find_closest(cent32, u_m[:, 2]), a1, a2)
    vis_d = wt * v_m
    cases.append(("aw_grid, main path", vis_d.shape[0],
                  lambda m: m.aw_fused_grid(pt_d, ws_d, rec_d, vis_d,
                                            shape)))

    # one channel of the cube observation, as w_image takes it
    obs_c, vd_c = cube_observation()
    centers_c, build_c = w_bank_inputs(torch, obs_c, dev)
    bank_c = torch.conj(build_c().to(torch.complex64)).resolve_conj()
    one = vd_c._replace(vis=vd_c.vis_chan[:, 0],
                        frequency=float(vd_c.frequencies[0]))
    uvw_c, f_c, vis_c = ds.idg_inputs(one, device=dev)
    g_c = ds.idg_grid_inputs(uvw_c, f_c, vis_c, theta=THETA, lam=LAM)
    wbin_c = find_closest(torch.as_tensor(centers_c, dtype=torch.float32,
                                          device=dev), g_c.w)
    cases.append(("wproj_grid, one cube channel", g_c.vis.shape[0],
                  lambda m: m.wproj_gridder(bank_c, g_c.grid_shape, g_c.p,
                                            wbin_c, g_c.vis)))

    return cases


def idg_grid_cases(torch, dev):
    """The streamed gridder's shapes, ``(label, records, call)``; each label
    names its run table's occupied runs, longest and mean run."""
    import numpy as np
    from chip_smoke import (BETA, LAM, SUBGRID, SUPPORT, THETA,
                            aw_cube_inputs, aw_track_inputs, cube_akerns,
                            cube_channel_prep, cube_observation,
                            idg_cycle_records, main_observation, run_stats)
    from ska_sdp_tpu_torch.kernels import _idg_unit_run_bound
    from ska_sdp_tpu_torch.kernels.idg_aw_records import (
        idg_aw_records_for_channel, idg_aw_run_records)
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.models import spectral as sp
    from ska_sdp_tpu_torch.types import SINGLE

    S = SUBGRID
    cases = []

    def add(label, recs, shape, scr, theta):
        n_occ, longest, mean = run_stats(recs[1], recs[2])
        cases.append((f"{label} ({n_occ} runs, longest {longest}, mean "
                      f"{mean:.1f})", int(recs[0].shape[1]),
                      lambda m: m.idg_aw_grid_from_records_stream(
                          *recs, shape, scr, theta=theta, subgrid=S,
                          taper_beta=BETA)))

    # the main path's records, unit screens (phase 3b)
    _, vd = main_observation()
    uvw, f, vis = ds.idg_inputs(vd, device=dev)
    g = ds.idg_grid_inputs(uvw, f, vis, theta=THETA, lam=LAM)
    zer = torch.zeros((vis.shape[0],), dtype=torch.int32, device=dev)
    recs = idg_aw_run_records(
        g.grid_shape, g.p, zer, zer, g.w, g.vis.real, g.vis.imag, subgrid=S,
        support=SUPPORT, max_runs=_idg_unit_run_bound(g.grid_shape, S,
                                                      SUPPORT), nant=1)
    add("idg_grid, main path", recs[:7], g.grid_shape,
        torch.ones((1, S, S), dtype=torch.complex64, device=dev), g.theta)

    # channel 0 of the cube observation: the IDG prep and the IDG-AW cube
    # raster's ordered prep (phase 25)
    n = int(round(THETA * LAM))
    kw = dict(subgrid=S, taper_beta=BETA, theta=THETA, lam=LAM, device=dev)
    for label, vdx, ak in (
            ("idg_grid, cube channel 0, IDG prep", cube_observation()[1],
             None),
            ("idg_grid, cube channel 0, IDG-AW cube raster",
             aw_cube_inputs(), cube_akerns())):
        res = (sp.idg_cube(vdx, **kw) if ak is None
               else sp.aw_idg_cube(vdx, ak, **kw))
        prep, r0, scr = cube_channel_prep(torch, dev, vdx, res.groups[0], ak)
        base, vis_s, *runs, _, _ = prep()
        rec0, _ = idg_aw_records_for_channel(base, vis_s[0], r0, subgrid=S)
        add(label, [rec0, *runs], (n, n), scr, THETA)

    # the IDG-AW track shape with random screens (phase 9)
    t = aw_track_inputs()
    scr = ds.antenna_screens(t.ak, S, THETA, LAM, None, SINGLE, dev)
    uvw, f, vis = ds.idg_inputs(t.vd, device=dev)
    a1, a2 = (torch.as_tensor(a.astype(np.int32), device=dev)
              for a in (t.a1, t.a2))
    ga, a1g, a2g = ds.aw_grid_inputs(uvw, a1, a2, f, vis, theta=THETA,
                                     lam=LAM, layout=None)
    recs = idg_aw_run_records(
        ga.grid_shape, ga.p, a1g, a2g, ga.w, ga.vis.real, ga.vis.imag,
        subgrid=S, support=SUPPORT,
        max_runs=ds.aw_run_bound(t.vd.antenna1, t.vd.antenna2, t.n),
        nant=t.nant)
    add("idg_grid, IDG-AW track shape", recs[:7], ga.grid_shape, scr,
        ga.theta)

    # the benchmark cell idg.cycle's crowded SKA1-Low core (phase 39)
    grid_args, _, kw = idg_cycle_records(torch, dev)
    add("idg_grid, idg.cycle core", grid_args, kw["grid"]["grid_shape"],
        kw["grid"]["screens"], kw["grid"]["theta"])
    return cases


def _random_grid(torch, dev, shape, seed):
    gen = torch.Generator(dev).manual_seed(seed)
    return torch.randn(shape, dtype=torch.complex64, device=dev,
                       generator=gen)


def idg_degrid_cases(torch, dev):
    """The streamed degridder's shapes, ``(label, records, call)``; each
    label names its run table's occupied runs, longest and mean run."""
    import numpy as np
    from chip_smoke import (BETA, LAM, SUBGRID, SUPPORT, THETA,
                            aw_track_inputs, idg_cycle_records,
                            main_observation, run_stats)
    from ska_sdp_tpu_torch.kernels import _idg_unit_run_bound
    from ska_sdp_tpu_torch.kernels.idg_aw_records import (
        idg_aw_degrid_records)
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.types import SINGLE

    S = SUBGRID
    cases = []

    def add(label, recs, grid, scr, theta):
        ext = recs[1]
        n_occ, longest, mean = run_stats(ext[:-1], ext[1:])
        cases.append((f"{label} ({n_occ} runs, longest {longest}, mean "
                      f"{mean:.1f})", int(recs[0].shape[1]),
                      lambda m: m.idg_aw_degrid_from_records_stream(
                          *recs, grid, scr, theta=theta, subgrid=S,
                          taper_beta=BETA)))

    # the main path's records, unit screens (phase 7b)
    _, vd = main_observation()
    uvw, f, vis = ds.idg_inputs(vd, device=dev)
    g = ds.idg_grid_inputs(uvw, f, vis, theta=THETA, lam=LAM)
    zer = torch.zeros((vis.shape[0],), dtype=torch.int32, device=dev)
    recs = idg_aw_degrid_records(
        g.grid_shape, g.p, zer, zer, g.w, subgrid=S, support=SUPPORT,
        max_runs=_idg_unit_run_bound(g.grid_shape, S, SUPPORT))
    add("idg_degrid, main path", recs[:7],
        _random_grid(torch, dev, g.grid_shape, 5),
        torch.ones((1, S, S), dtype=torch.complex64, device=dev), g.theta)

    # the IDG-AW track shape with random screens (phase 9)
    t = aw_track_inputs()
    scr = ds.antenna_screens(t.ak, S, THETA, LAM, None, SINGLE, dev)
    uvw, f, vis = ds.idg_inputs(t.vd, device=dev)
    a1, a2 = (torch.as_tensor(a.astype(np.int32), device=dev)
              for a in (t.a1, t.a2))
    d = ds.degrid_inputs(_random_grid(torch, dev, g.grid_shape, 6).real
                         .contiguous(),
                         uvw, f, theta=THETA, lam=LAM, subgrid=S,
                         taper_beta=BETA)
    recs = idg_aw_degrid_records(
        tuple(d.grid.shape), d.p, a1, a2, d.w, subgrid=S, support=SUPPORT,
        max_runs=ds.aw_run_bound(t.vd.antenna1, t.vd.antenna2, t.n))
    add("idg_degrid, IDG-AW track shape", recs[:7],
        _random_grid(torch, dev, tuple(d.grid.shape), 7), scr, d.theta)

    # the benchmark cell idg.cycle's crowded SKA1-Low core (phase 39)
    _, degrid_args, kw = idg_cycle_records(torch, dev)
    add("idg_degrid, idg.cycle core", degrid_args, kw["degrid"]["grid"],
        kw["degrid"]["screens"], kw["degrid"]["theta"])
    return cases


def idg_tile_cases(torch, dev):
    """The fixed-tile route's shapes, ``(label, records, call)``; each label
    names its occupied subgrids (the runs), longest and mean."""
    import numpy as np
    from chip_smoke import (BETA, LAM, SUPPORT, THETA, cube_group_inputs,
                            cube_observation, main_observation, run_stats)
    from ska_sdp_tpu_torch.kernels import idg_tile
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.models import spectral as sp

    cases = []

    def add(label, shape, S, theta, p, w, vis=None, recs=None, starts=None):
        """Both wrappers at one shape: the gridder on ``vis`` (or on given
        ``recs``/``starts``), the degridder on a random grid."""
        if recs is None:
            recs, starts = idg_tile.idg_bin_records(
                shape, p, w, vis.real, vis.imag, subgrid=S, support=SUPPORT)
        kw = dict(theta=theta, subgrid=S, taper_beta=BETA)
        n_occ, longest, mean = run_stats(starts[:-1], starts[1:])
        cases.append((f"idg_tile, gridder, {label} (S={S}, {n_occ} runs, "
                      f"longest {longest}, mean {mean:.1f})",
                      int(recs.shape[1]),
                      lambda m: m.idg_grid_from_records(recs, starts, shape,
                                                        **kw)))
        drecs, dstarts, order, _ = idg_tile.prep_with_order(
            shape, p, w, subgrid=S, support=SUPPORT)
        grid = _random_grid(torch, dev, shape, 9)
        n_occ, longest, mean = run_stats(dstarts[:-1], dstarts[1:])
        cases.append((f"idg_tile, degridder, {label} (S={S}, {n_occ} runs, "
                      f"longest {longest}, mean {mean:.1f})",
                      int(drecs.shape[1]),
                      lambda m: m.idg_degrid_from_records(
                          drecs, dstarts, order, grid, **kw)))

    # the main path's records at S=32 (phases 20b, 22)
    _, vd = main_observation()
    uvw, f, vis = ds.idg_inputs(vd, device=dev)
    g = ds.idg_grid_inputs(uvw, f, vis, theta=THETA, lam=LAM)
    add("main path", g.grid_shape, 32, g.theta, g.p, g.w, g.vis)

    # channel 0 of the cube observation at S=32: the multi prep, as
    # idg_cube grids it (phase 25), and that channel's degrid prep
    vd_c = cube_observation()[1]
    res = sp.idg_cube(vd_c, subgrid=32, taper_beta=BETA, theta=THETA,
                      lam=LAM, device=dev)
    uvw1, vis1, r0, _ = cube_group_inputs(torch, dev, vd_c, res.groups[0])
    n = int(round(THETA * LAM))
    base, vis_s, starts = idg_tile.idg_bin_records_multi(
        (n, n), uvw1 / LAM, uvw1[:, 2], vis1.real, vis1.imag, subgrid=32,
        support=SUPPORT)
    recs, _ = idg_tile.idg_records_for_channel(base, vis_s[0], r0,
                                               subgrid=32)
    add("cube channel 0", (n, n), 32, THETA, uvw1 * r0 / LAM,
        uvw1[:, 2] * r0, recs=recs, starts=starts)

    # 512² at S=48 (phase 20a's records)
    rng = np.random.default_rng(50)
    n_mid = 200_000
    p_mid = rng.uniform(-0.53, 0.53, (n_mid, 3)).astype(np.float32)
    w_mid = rng.uniform(-1e5, 1e5, n_mid).astype(np.float32)
    vis_mid = (rng.standard_normal(n_mid)
               + 1j * rng.standard_normal(n_mid)).astype(np.complex64)
    pm, wm, vm = (torch.as_tensor(a, device=dev)
                  for a in (p_mid, w_mid, vis_mid))
    add("512²", (512, 512), 48, THETA, pm, wm, vm)
    return cases


def wproj_degrid_cases(torch, dev):
    """The bank gather's shapes, ``(label, records, call)``."""
    from chip_smoke import LAM, THETA, bench_records, main_observation, \
        w_bank_inputs
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.ops import mirror_uvw, uvw_lambda
    from ska_sdp_tpu_torch.ops.search import find_closest

    # the benchmark's bank shape and its random grid (phase 12b)
    b = bench_records()
    bank_b, centers_b, uvw_b, vis_b, grid_b = (
        torch.as_tensor(b[k], device=dev)
        for k in ("bank", "centers", "uvw", "vis", "grid"))
    uvw1, _ = mirror_uvw(uvw_b, vis_b)
    wbin_b = find_closest(centers_b, uvw1[:, 2])
    cases = [("wproj_degrid, bench shape", uvw1.shape[0],
              lambda m: m.wproj_degridder(bank_b, grid_b, uvw1 / LAM,
                                          wbin_b))]

    # w_predict_vis's records: unmirrored, the raw bank (phase 13)
    obs, vd = main_observation()
    centers, build_bank = w_bank_inputs(torch, obs, dev)
    bank = build_bank().to(torch.complex64)
    uvw, f, vis = ds.idg_inputs(vd, device=dev)
    uvw0 = uvw_lambda(f, uvw)
    wbin0 = find_closest(torch.as_tensor(centers, dtype=torch.float32,
                                         device=dev), uvw0[:, 2])
    n = int(round(THETA * LAM))
    grid = _random_grid(torch, dev, (n, n), 8)
    cases.append(("wproj_degrid, w_predict_vis records", uvw0.shape[0],
                  lambda m: m.wproj_degridder(bank, grid, uvw0 / LAM,
                                              wbin0)))
    return cases


def device_ms(torch, fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``torch.profiler``'s device
    events summed over ``reps`` calls after a warm-up, divided by
    ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / reps / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--only", nargs="+",
                    choices=("idg_grid", "idg_degrid", "idg_tile",
                             "wproj_grid", "wproj_degrid", "aw_grid"),
                    help="time only these kernels' shapes")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device visible", file=sys.stderr)
        return 1
    from chip_smoke import rel_l2, smi, timed_ms
    from ska_sdp_tpu_torch.kernels import aw_fused, idg_tile, wproj
    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream

    aw_o, wproj_o, stream_o, tile_o = load_other(args.other)
    others = {"aw_grid": aw_o, "wproj_grid": wproj_o,
              "wproj_degrid": wproj_o, "idg_grid": stream_o,
              "idg_degrid": stream_o, "idg_tile": tile_o}
    mods = {"aw_grid": aw_fused, "wproj_grid": wproj, "wproj_degrid": wproj,
            "idg_grid": stream, "idg_degrid": stream, "idg_tile": idg_tile}
    case_sets = {"aw_grid": bank_aw_cases, "wproj_grid": bank_aw_cases,
                "idg_grid": idg_grid_cases, "idg_degrid": idg_degrid_cases,
                "idg_tile": idg_tile_cases,
                "wproj_degrid": wproj_degrid_cases}
    wanted = args.only or list(case_sets)
    dev = torch.device("cuda", 0)
    card = smi()
    print(f"nvidia-smi: {card}")
    cases = []
    for make in dict.fromkeys(case_sets[k] for k in wanted):
        cases += make(torch, dev)
    cases = [c for c in cases if c[0].split(",")[0] in wanted]

    for label, n, call in cases:
        kind = label.split(",")[0]
        this, other = mods[kind], others[kind]
        err = rel_l2(call(this).cpu().numpy(), call(other).cpu().numpy())
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            mod = other if who == "other" else this
            times[who].append(timed_ms(torch, lambda: call(mod),
                                       reps=args.reps))
        dev_ms = {who: device_ms(torch, lambda: call(mod), args.reps)
                  for who, mod in (("other", other), ("this", this))}
        print(json.dumps({
            "case": label, "records": n, "rel_l2_this_vs_other": err,
            "this_ms": times["this"], "other_ms": times["other"],
            "speedup": min(times["other"]) / min(times["this"]),
            "this_device_ms": dev_ms["this"],
            "other_device_ms": dev_ms["other"],
            "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
