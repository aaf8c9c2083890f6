"""The benchmark's frozen copies of the A-kernels, the w-plane centres,
the model image and the bank equal the port's originals at a tiny size,
and its SKA1-Low snapshot has the shapes its configuration states."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from benchmark import observation as ob
from benchmark.tests.conftest import BENCH
from benchmark.wbank import w_bank, w_kernels
from ska_sdp_tpu_torch.config import KernelOptions
from ska_sdp_tpu_torch.io import synthetic as syn
from ska_sdp_tpu_torch.ops.wkernel import w_kernel

SEED = 2**31 + 17


def test_akerns_and_centres_equal_the_port():
    mine = ob.akern_stamps(9, 7, SEED)
    port = syn.akern_stamps(syn.SyntheticConfig(nant=9, akern_size=7,
                                                seed=SEED))
    np.testing.assert_array_equal(mine, port)
    obs = syn.simulate_observation(syn.SyntheticConfig(
        theta=0.05, lam=5120, nant=9, ntime=5, seed=SEED))
    np.testing.assert_array_equal(
        ob.w_plane_centers(obs, 6),
        syn.w_plane_centers(obs, syn.SyntheticConfig(nw_planes=6)))


def test_bank_equals_the_port():
    # more planes than one call of w_kernels takes, so w_bank joins parts
    centers = np.linspace(-300.0, 300.0, 6)
    opts = KernelOptions(qpx=4, npix_ff=32, npix_kern=7)
    port = w_kernel(0.05, torch.as_tensor(centers), opts)
    mine = w_kernels(0.05, centers, 4, 32, 7)
    torch.testing.assert_close(mine, port, rtol=0, atol=0)
    torch.testing.assert_close(w_bank(0.05, centers, 4, 32, 7),
                               port.to(torch.complex64), rtol=0, atol=0)


def _snapshot(seed, **kw):
    cfg = json.loads((BENCH / "configs" / "ska1low-idg.json").read_text())
    return cfg, dataclasses.replace(ob.from_config(cfg, 5, seed), **kw)


def test_layout_has_the_configured_core_arms_and_longest_baseline():
    cfg, oc = _snapshot(2**31 + 5)
    enu = ob.station_layout(oc)
    tel = cfg["telescope"]
    assert enu.shape == (tel["stations"], 3)
    d = np.hypot(*(enu[:, None, :2] - enu[None, :, :2]).transpose(2, 0, 1))
    assert abs(d.max() - tel["max_baseline_m"]) < 1e-6 * d.max()
    r = np.hypot(enu[:, 0], enu[:, 1])
    # the core's disc (scaled with the array by well under 10%)
    assert (r < 0.55 * tel["core_diameter_m"]).sum() >= tel["core_stations"]
    np.testing.assert_array_equal(enu, ob.station_layout(oc))


def test_snapshot_fits_the_grid_and_keeps_dumps_consecutive():
    cfg, oc = _snapshot(7, dumps=3, stations=32, core_stations=14)
    obs = ob.simulate_observation(oc)
    nbl = 32 * 31 // 2
    assert obs["n"] == 3 * nbl and obs["uvw"].shape == (3 * nbl, 3)
    uv = obs["uvw"][:, :2] * (oc.freq_hz / ob.C)
    # every baseline inside the grid's ±lam/2 with the margin the
    # configuration derives
    assert np.abs(uv).max() < cfg["settings"]["lam"] / 2 - 3000
    t = obs["time"].reshape(3, nbl)
    assert np.all(t == t[:, :1]) and np.allclose(
        np.diff(t[:, 0]) * 86400, oc.dump_s)
    np.testing.assert_array_equal(obs["antenna1"].reshape(3, nbl)[1],
                                  obs["antenna1"][:nbl])
    src, vis = ob.sky(obs, oc, 0)
    src2, vis2 = ob.sky(obs, oc, 0)
    assert vis.dtype == np.complex64 and vis.shape == (3 * nbl,)
    np.testing.assert_array_equal(vis, vis2)
    assert not np.array_equal(ob.sky(obs, oc, 1)[1], vis)

