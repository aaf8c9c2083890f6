#!/usr/bin/env python3
"""Device busy and idle share of ska_sdp_tpu_torch's in-memory entry points
on one NVIDIA GPU, under ``torch.profiler``.

    python3 scripts/profile_torch.py [--calls 5] [--warmup 3]

At ``chip_smoke.py``'s shapes (2400² grid; 1,046,528 visibilities of the
512-station observation for ``idg_image`` and ``idg_predict_vis`` at S=64
(the streamed kernels) and at S=32 (the fixed-tile route onto them),
``w_image``, ``w_predict_vis`` and ``aw_image``; 1,048,320 pair-major
track records with random A-kernels for ``aw_idg_image`` and
``aw_predict_vis``; the 32-plane, qpx=8, 15² w-kernel bank built on the
card; near-delta A-kernels of the 512 stations for ``aw_image``; and the
spectral cubes of ``chip_smoke.py`` phase 24: ``idg_cube`` (S=64) and
``w_cube`` of bench cell 8's 8-channel observation, ``aw_idg_cube`` of the
8-channel track raster; ``aw_idg_image`` and ``aw_predict_vis`` at S=48 on
the 512-station observation with its near-delta A-kernels; and the
PSF-normalised imaging ``psf_image`` of ``--mode simple``, ``conv`` and
``wcache`` on the 512-station observation; the slab loops of ``--mode w
--checkpoint`` (``w_image_slabs``) and ``--out-of-core``
(``w_image_streamed``, both passes) on the 512-station observation in 4
slabs of 262,144 records, the grid copied after each slab into the
page-locked host buffer a checkpoint write copies into), each entry is called ``--warmup`` times, then
``--calls`` times without the profiler and ``--calls`` times under it,
each call ending in a synchronise.  Per entry it prints one JSON line: the
wall time per call with the profiler off and on (host clock), the device
busy time per call (the sum of the device events: kernels, copies and
memsets, on one stream), the idle share ``1 − busy / wall`` against each
wall, and the three largest device items.  The card's name and power
limit come first.  It needs a CUDA card and stops without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile(torch, fn, calls: int, warmup: int):
    """``(wall ms per call without the profiler, wall ms per call under it,
    {device item: ms per call})``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
        torch.cuda.synchronize()
    bare = (time.perf_counter() - t0) / calls * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
    items: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            items[e.name] = (items.get(e.name, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / calls)
    return bare, wall, items


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device visible", file=sys.stderr)
        return 1
    from chip_smoke import (BETA, LAM, SLAB, SUBGRID, THETA, aw_cube_inputs,
                            aw_track_inputs, cube_akerns, cube_observation,
                            main_akerns, main_observation, smi,
                            snapped_model, w_bank_inputs)
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.models import spectral as sp

    dev = torch.device("cuda", 0)
    card = smi()
    print(f"nvidia-smi: {card}; torch {torch.__version__}")

    obs, vd = main_observation()
    model, _ = snapped_model(obs, int(round(THETA * LAM)))
    t_aw = aw_track_inputs()
    vd_aw, ak = t_aw.vd, t_aw.ak
    centers, build_bank = w_bank_inputs(torch, obs, dev)
    bank = build_bank()
    ak_main = main_akerns()
    obs_c, vd_c = cube_observation()
    centers_c, build_bank_c = w_bank_inputs(torch, obs_c, dev)
    bank_c = build_bank_c()
    vd_aw_c, ak_c = aw_cube_inputs(), cube_akerns()

    kw = dict(theta=THETA, lam=LAM, device=dev)
    n_vis = vd.vis.shape[0]
    readers = {"uvw": lambda s0, c: vd.uvw[s0:s0 + c],
               "vis": lambda s0, c: vd.vis[s0:s0 + c]}

    host = ds.HostCopy()

    def to_host(grid, _next):
        host(grid)

    idg = dict(kw, subgrid=SUBGRID, taper_beta=BETA)
    idg32 = dict(idg, subgrid=32)
    aw48 = dict(idg, subgrid=48)
    entries = {
        "idg_image": lambda: ds.idg_image(vd, **idg),
        "idg_predict_vis": lambda: ds.idg_predict_vis(vd, model, **idg),
        "idg_image S=32": lambda: ds.idg_image(vd, **idg32),
        "idg_predict_vis S=32": lambda: ds.idg_predict_vis(vd, model,
                                                           **idg32),
        "aw_idg_image": lambda: ds.aw_idg_image(vd_aw, ak, **idg),
        "aw_predict_vis": lambda: ds.aw_predict_vis(vd_aw, ak, model, **idg),
        "w_image": lambda: ds.w_image(vd, bank, centers, **kw),
        "w_predict_vis": lambda: ds.w_predict_vis(vd, bank, centers, model,
                                                  **kw),
        "aw_image": lambda: ds.aw_image(vd, bank, centers, ak_main, **kw),
        "idg_cube (8 ch)": lambda: sp.idg_cube(vd_c, **idg),
        "aw_idg_cube (8 ch)": lambda: sp.aw_idg_cube(vd_aw_c, ak_c, **idg),
        "w_cube (8 ch)": lambda: sp.w_cube(vd_c, bank_c, centers_c, **kw),
        "aw_idg_image S=48": lambda: ds.aw_idg_image(vd, ak_main, **aw48),
        "aw_predict_vis S=48": lambda: ds.aw_predict_vis(vd, ak_main, model,
                                                         **aw48),
        "psf_image simple": lambda: ds.psf_image(vd, "simple", **kw),
        "psf_image conv": lambda: ds.psf_image(vd, "conv", **kw),
        "psf_image wcache": lambda: ds.psf_image(vd, "wcache", **kw),
        "w_image_slabs (4 slabs)": lambda: ds.w_image_slabs(
            vd, bank, centers, slab=SLAB, on_slab=to_host, **kw),
        "w_image_streamed (4 slabs)": lambda: ds.w_image_streamed(
            readers, n_vis, vd.frequency, bank, centers, slab=SLAB,
            on_slab=to_host, **kw),
    }
    for name, fn in entries.items():
        bare, wall, items = profile(torch, fn, args.calls, args.warmup)
        busy = sum(items.values())
        top = sorted(items.items(), key=lambda kv: -kv[1])[:3]
        measured = busy > 0
        print(json.dumps({
            "entry": name, "wall_ms": bare, "wall_ms_profiled": wall,
            "device_busy_ms": busy if measured else "not measured",
            "idle_share": 1.0 - busy / bare if measured else "not measured",
            "idle_share_profiled": (1.0 - busy / wall if measured
                                    else "not measured"),
            "top_device_items_ms": {k[:60]: v for k, v in top},
            "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
