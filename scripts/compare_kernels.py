#!/usr/bin/env python3
"""Time the bank w-projection scatter and the fused AW gridder of this
checkout against those of another checkout, in one process on one NVIDIA
GPU, in turns.

    python3 scripts/compare_kernels.py --other DIR [--reps 7]

``DIR`` holds a checkout of another commit; its ``ska_sdp_tpu_torch/``
package is loaded under another name and builds its CUDA kernels into its
own ``build/``.  At ``chip_smoke.py``'s shapes, both versions of each
wrapper get the same inputs: ``wproj_gridder`` at the reference
benchmark's bank shape (phase 12b: 1,048,576 records, NW=32, QPX=8, 15²,
2400²), on ``w_image``'s records of the 512-station observation, and on
one channel of the cube observation (phase 24, channel 0 as ``w_image``
takes it); ``aw_fused_grid`` at the benchmark's fused-AW shape (phase 16b:
524,288 records, 64 stations) and at the main path's 512 stations (16d:
1,046,528 records).  Per shape the two grids are compared (rel-L2), then
each wrapper is timed with CUDA events (median of ``--reps`` after a
warm-up, its prep included) in the order other, this, this, other.  It
prints the card's name and power limit, then one JSON line per shape with
both pairs of times.  It needs a CUDA card and stops without one.
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
    """The other checkout's ``(aw_fused, wproj)`` kernel modules."""
    pkg = os.path.join(os.path.abspath(root), "ska_sdp_tpu_torch")
    name = "other_ska_sdp_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{name}.kernels.aw_fused"),
            importlib.import_module(f"{name}.kernels.wproj"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device visible", file=sys.stderr)
        return 1
    from chip_smoke import (LAM, THETA, bench_records, cube_observation,
                            main_akerns, main_observation, rel_l2, smi,
                            timed_ms, w_bank_inputs)
    from ska_sdp_tpu_torch.kernels import aw_fused, wproj
    from ska_sdp_tpu_torch.models import dataset as ds
    from ska_sdp_tpu_torch.ops import doweight, mirror_uvw, uvw_lambda
    from ska_sdp_tpu_torch.ops.search import find_closest

    other_aw, other_wproj = load_other(args.other)
    dev = torch.device("cuda", 0)
    card = smi()
    print(f"nvidia-smi: {card}")

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

    for label, n, call in cases:
        other = other_wproj if label.startswith("wproj") else other_aw
        this = wproj if label.startswith("wproj") else aw_fused
        err = rel_l2(call(this).cpu().numpy(), call(other).cpu().numpy())
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            mod = other if who == "other" else this
            times[who].append(timed_ms(torch, lambda: call(mod),
                                       reps=args.reps))
        print(json.dumps({
            "case": label, "records": n, "rel_l2_this_vs_other": err,
            "this_ms": times["this"], "other_ms": times["other"],
            "speedup": min(times["other"]) / min(times["this"]),
            "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
