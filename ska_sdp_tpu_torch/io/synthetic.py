"""Synthetic SKA1-Low-style observations (port of the visibility part of
``ska_sdp_tpu/io/synthetic.py``).

Antennas on a random compact layout, Earth-rotation uvw tracks, and
visibilities of a few point sources from the measurement equation

    V(u, v, w) = Σ_s A_s · exp(−2πi (u·l_s + v·m_s + w·(√(1 − l² − m²) − 1)))

so imaging tests can check that the sources reappear at ``(l_s, m_s)``.
Everything is numpy float64 on the host, seeded by ``cfg.seed``; the same
seed gives the same arrays as the reference package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import h5, schema


@dataclass(frozen=True)
class SyntheticConfig:
    theta: float = 0.008          # field of view (l, m extent)
    lam: int = 300000             # grid resolution in wavelengths
    nant: int = 16
    ntime: int = 24
    freq: float = 1.5e8           # Hz (first channel)
    nchan: int = 1                # spectral channels (/vis/frequency [nch])
    chan_bw: float = 1.0e5        # channel spacing in Hz
    declination: float = 0.7      # radians
    # layout diameter in metres; None keeps baselines inside the ±lam/2
    # uv box (~0.42·lam wavelengths)
    max_baseline_m: float | None = None
    nsources: int = 5
    seed: int = 1234


def simulate_observation(cfg: SyntheticConfig) -> dict:
    """uvw tracks and point-source visibilities as numpy arrays matching
    the ``/vis`` ingest contract, plus ``sources`` ``[nsrc, 3]`` (l, m,
    flux) and ``n``."""
    rng = np.random.default_rng(cfg.seed)
    max_baseline_m = cfg.max_baseline_m
    if max_baseline_m is None:
        max_baseline_m = 0.42 * cfg.lam * 299792458.0 / cfg.freq
    r = max_baseline_m / 2 * np.sqrt(rng.uniform(0.03, 1.0, cfg.nant))
    az = rng.uniform(0, 2 * np.pi, cfg.nant)
    ants = np.stack([r * np.cos(az), r * np.sin(az),
                     rng.normal(0, 5, cfg.nant)], 1)

    i_idx, j_idx = np.triu_indices(cfg.nant, k=1)
    L = ants[j_idx] - ants[i_idx]                      # [nbl, 3] metres
    nbl = L.shape[0]

    hours = np.linspace(-0.5, 0.5, cfg.ntime)          # hour angles (rad)
    sd, cd = np.sin(cfg.declination), np.cos(cfg.declination)
    uvw = np.empty((cfg.ntime, nbl, 3))
    for t, h in enumerate(hours):
        sh, ch = np.sin(h), np.cos(h)
        rot = np.array([
            [sh, ch, 0.0],
            [-sd * ch, sd * sh, cd],
            [cd * ch, -cd * sh, sd],
        ])
        uvw[t] = L @ rot.T
    uvw = uvw.reshape(-1, 3)                            # metres
    n = uvw.shape[0]

    a1 = np.tile(i_idx, cfg.ntime).astype(np.int64)
    a2 = np.tile(j_idx, cfg.ntime).astype(np.int64)
    time = np.repeat(np.linspace(55000.0, 55000.01, cfg.ntime), nbl)

    lm_extent = 0.35 * cfg.theta
    srcs_l = rng.uniform(-lm_extent, lm_extent, cfg.nsources)
    srcs_m = rng.uniform(-lm_extent, lm_extent, cfg.nsources)
    flux = rng.uniform(0.5, 2.0, cfg.nsources)

    # channel c sees the same sky through uvw scaled by f_c / c
    freqs = cfg.freq + cfg.chan_bw * np.arange(cfg.nchan)
    phase_geom = (
        uvw[:, 0:1] * srcs_l[None, :]
        + uvw[:, 1:2] * srcs_m[None, :]
        + uvw[:, 2:3]
        * (np.sqrt(1.0 - srcs_l**2 - srcs_m**2) - 1.0)[None, :]
    )                                                   # [n, nsrc] metres
    scale = freqs / 299792458.0                         # [nch] 1/m
    arg = phase_geom[:, None, :] * scale[None, :, None]  # [n, nch, nsrc]
    vis = (np.exp(-2j * np.pi * arg) * flux[None, None, :]).sum(axis=2)

    return {
        "uvw": uvw,
        "vis": vis.reshape(cfg.ntime, nbl, cfg.nchan),
        "antenna1": a1,
        "antenna2": a2,
        "time": time,
        "frequency": freqs,
        "sources": np.stack([srcs_l, srcs_m, flux], axis=1),
        "n": n,
    }


def write_vis_file(path: str, obs: dict) -> None:
    """Write an observation from :func:`simulate_observation` as ``/vis``."""
    h5.create_file(path)
    h5.write_dataset(path, schema.VIS_VIS, obs["vis"].astype(np.complex128))
    h5.write_dataset(path, schema.VIS_UVW, obs["uvw"].astype(np.float64))
    h5.write_dataset(path, schema.VIS_ANTENNA1, obs["antenna1"])
    h5.write_dataset(path, schema.VIS_ANTENNA2, obs["antenna2"])
    h5.write_dataset(path, schema.VIS_TIME, obs["time"].astype(np.float64))
    h5.write_dataset(path, schema.VIS_FREQUENCY,
                     obs["frequency"].astype(np.float64))
