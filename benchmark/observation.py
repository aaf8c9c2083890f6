"""The benchmark's inputs, made from the seed.

The observation is a snapshot of SKA1-Low as a configuration file states
it: the stations of the array's published structure (a dense core and
six-station clusters on three spiral arms out to the longest baseline)
drawn from the seed, Earth-rotation uvw tracks of consecutive dumps of
one channel around the field's transit, and the visibilities of a few
point sources over those tracks.  The A-kernels, the w-plane centres and
the model image are frozen copies of the port's originals
(``ska_sdp_tpu_torch/io/synthetic.py``: ``akern_stamps``,
``w_plane_centers``; ``chip_smoke.py``: ``snapped_model``), held equal to
them by ``benchmark/tests/test_bench_frozen.py``, so that a later change
to the program cannot change what the benchmark feeds it.

The layout and the tracks are numpy on the host; the visibilities are
made in float64 on the given device and kept on the host as complex64,
as a measurement set holds them.  The same seed gives the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

C = 299792458.0
SIDEREAL_RAD_S = 7.2921159e-5        # the Earth's rotation rate


@dataclass(frozen=True)
class ObsConfig:
    """An observation: the array, the field, the dumps and the sky."""

    stations: int
    core_stations: int
    core_diameter_m: float
    cluster_size: int
    arms: int
    cluster_spread_m: float
    arm_twist: float                  # radians of azimuth per e-folding
    max_baseline_m: float
    height_sigma_m: float
    latitude_deg: float
    freq_hz: float
    dump_s: float
    dumps: int
    declination_deg: float
    hour_angle_deg: float             # the snapshot's centre
    theta: float
    sources: int
    akern_size: int
    seed: int


def from_config(cfg: dict, sources: int, seed: int) -> ObsConfig:
    """The observation a configuration file states (``telescope``,
    ``observation``, ``settings.theta``), with ``sources`` point sources a
    sky and the run's seed."""
    tel, o = cfg["telescope"], cfg["observation"]
    if o["channels"] != 1:
        raise ValueError("the entries image one channel a call")
    return ObsConfig(
        stations=tel["stations"], core_stations=tel["core_stations"],
        core_diameter_m=tel["core_diameter_m"],
        cluster_size=tel["cluster_size"], arms=tel["arms"],
        cluster_spread_m=tel["cluster_spread_m"],
        arm_twist=tel["arm_twist_rad"], max_baseline_m=tel["max_baseline_m"],
        height_sigma_m=tel["height_sigma_m"],
        latitude_deg=tel["latitude_deg"], freq_hz=o["freq_hz"],
        dump_s=o["dump_s"], dumps=o["dumps"],
        declination_deg=o["declination_deg"],
        hour_angle_deg=o["hour_angle_deg"], theta=cfg["settings"]["theta"],
        sources=sources, akern_size=tel.get("akern_size", 15), seed=seed)


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng([k % 2**63 for k in key])


def station_layout(cfg: ObsConfig) -> np.ndarray:
    """``[stations, 3]`` east, north, up in metres: ``core_stations``
    uniform in the core's disc; the rest in clusters of ``cluster_size``
    (uniform within ``cluster_spread_m`` of the cluster's centre), the
    centres on ``arms`` logarithmic spirals at radii spaced evenly in
    log from the core's edge outward; then every position scaled so that
    the longest baseline is ``max_baseline_m``."""
    rng = _rng(cfg.seed)
    nc = cfg.core_stations
    r = cfg.core_diameter_m / 2 * np.sqrt(rng.uniform(0.0, 1.0, nc))
    az = rng.uniform(0.0, 2 * np.pi, nc)
    east, north = [r * np.cos(az)], [r * np.sin(az)]
    n_clusters = (cfg.stations - nc) // cfg.cluster_size
    if n_clusters * cfg.cluster_size != cfg.stations - nc \
            or n_clusters % cfg.arms:
        raise ValueError("the arm stations do not split into equal arms "
                         "of whole clusters")
    per_arm = n_clusters // cfg.arms
    r0 = cfg.core_diameter_m / 2
    r1 = cfg.max_baseline_m / np.sqrt(3.0)
    radii = r0 * (r1 / r0) ** (np.arange(1, per_arm + 1) / per_arm)
    for arm in range(cfg.arms):
        phi = 2 * np.pi * arm / cfg.arms + cfg.arm_twist * np.log(radii / r0)
        for rc, ph in zip(radii, phi):
            d = cfg.cluster_spread_m * np.sqrt(
                rng.uniform(0.0, 1.0, cfg.cluster_size))
            a = rng.uniform(0.0, 2 * np.pi, cfg.cluster_size)
            east.append(rc * np.cos(ph) + d * np.cos(a))
            north.append(rc * np.sin(ph) + d * np.sin(a))
    en = np.stack([np.concatenate(east), np.concatenate(north)], 1)
    diff = en[:, None, :] - en[None, :, :]
    longest = float(np.sqrt((diff * diff).sum(-1)).max())
    en *= cfg.max_baseline_m / longest
    up = rng.normal(0.0, cfg.height_sigma_m, cfg.stations)
    return np.concatenate([en, up[:, None]], 1)


def _equatorial(enu: np.ndarray, latitude: float) -> np.ndarray:
    """East, north, up to the local equatorial X, Y, Z (X towards hour
    angle 0 on the equator, Z towards the pole)."""
    sl, cl = np.sin(latitude), np.cos(latitude)
    e, n, u = enu[:, 0], enu[:, 1], enu[:, 2]
    return np.stack([-sl * n + cl * u, e, cl * n + sl * u], 1)


def simulate_observation(cfg: ObsConfig) -> dict:
    """Time-major records of ``cfg.dumps`` consecutive dumps (dump k is
    records ``k·nbl`` to ``(k + 1)·nbl``, baselines ``i < j`` in
    ``triu_indices`` order): ``uvw`` [n, 3] float64 metres, ``antenna1``,
    ``antenna2`` [n] int64, ``time`` [n] float64 (days), ``frequency``
    [1], ``n``, and the layout ``stations`` [nant, 3]."""
    enu = station_layout(cfg)
    xyz = _equatorial(enu, np.deg2rad(cfg.latitude_deg))
    i_idx, j_idx = np.triu_indices(cfg.stations, k=1)
    L = xyz[j_idx] - xyz[i_idx]
    nbl = L.shape[0]
    t = cfg.dump_s * (np.arange(cfg.dumps) - (cfg.dumps - 1) / 2)
    hours = np.deg2rad(cfg.hour_angle_deg) + SIDEREAL_RAD_S * t
    dec = np.deg2rad(cfg.declination_deg)
    sd, cd = np.sin(dec), np.cos(dec)
    uvw = np.empty((cfg.dumps, nbl, 3))
    for k, h in enumerate(hours):
        sh, ch = np.sin(h), np.cos(h)
        rot = np.array([
            [sh, ch, 0.0],
            [-sd * ch, sd * sh, cd],
            [cd * ch, -cd * sh, sd],
        ])
        uvw[k] = L @ rot.T
    return {
        "uvw": uvw.reshape(-1, 3),
        "antenna1": np.tile(i_idx, cfg.dumps).astype(np.int64),
        "antenna2": np.tile(j_idx, cfg.dumps).astype(np.int64),
        "time": np.repeat(55000.0 + (t - t[0]) / 86400.0, nbl),
        "frequency": np.array([cfg.freq_hz]),
        "n": cfg.dumps * nbl,
        "stations": enu,
    }


def sky(obs: dict, cfg: ObsConfig, index: int, device=None):
    """Sky ``index`` over ``obs``' tracks: ``(sources [nsrc, 3] (l, m,
    flux), vis [n] complex64 numpy)``.  The sources lie inside ±0.35·θ,
    drawn from ``(seed, index)``; the visibilities are the measurement
    equation's sum over them, in float64 on ``device``."""
    rng = _rng(cfg.seed, 1 + index)
    ext = 0.35 * cfg.theta
    src = np.stack([rng.uniform(-ext, ext, cfg.sources),
                    rng.uniform(-ext, ext, cfg.sources),
                    rng.uniform(0.5, 2.0, cfg.sources)], 1)
    uvw = torch.as_tensor(obs["uvw"], dtype=torch.float64, device=device)
    s = torch.as_tensor(src, dtype=torch.float64, device=device)
    l, m, flux = s[:, 0], s[:, 1], s[:, 2]
    ph = (uvw[:, 0:1] * l + uvw[:, 1:2] * m
          + uvw[:, 2:3] * (torch.sqrt(1.0 - l * l - m * m) - 1.0))
    ph = ph * (-2.0 * np.pi * float(obs["frequency"][0]) / C)
    vis = (torch.polar(flux.expand_as(ph).contiguous(), ph)).sum(1)
    return src, vis.to(torch.complex64).cpu().numpy()


def w_plane_centers(obs: dict, nw_planes: int) -> np.ndarray:
    """``nw_planes`` evenly spaced w-plane centres over the observed ±w
    range in wavelengths at the highest channel, with 5% margin."""
    f_top = float(obs["frequency"][-1])
    w_l = np.abs(obs["uvw"][:, 2]) * (f_top / C)
    wmax = float(w_l.max()) * 1.05 + 1e-3
    return np.linspace(-wmax, wmax, nw_planes)


def akern_stamps(nant: int, size: int, seed: int) -> np.ndarray:
    """The near-delta A-kernels ``[nant, 2, 2, s, s]`` complex128 (antenna,
    time, frequency): a unit centre plus 0.01·(N(0,1) + i·N(0,1)) per
    pixel from seed ``seed + 1``.  ``[:, 0, 0]`` is the first time and
    frequency."""
    rng = np.random.default_rng((seed + 1) % 2**63)
    s = size
    out = np.zeros((nant, 2, 2, s, s), np.complex128)
    out[..., s // 2, s // 2] = 1.0
    for ant in range(nant):
        for it in range(2):
            for jf in range(2):
                out[ant, it, jf] += 0.01 * (rng.standard_normal((s, s))
                                            + 1j * rng.standard_normal((s, s)))
    return out


def snapped_model(sources, n: int, lam: int) -> np.ndarray:
    """The ``[n, n]`` float32 model image of ``sources``, each snapped to a
    pixel centre inside the central 75%."""
    model = np.zeros((n, n), np.float32)
    for l, m, flux in sources:
        py, px = int(round(n / 2 + m * lam)), int(round(n / 2 + l * lam))
        if not (n // 8 <= min(py, px) and max(py, px) < n - n // 8):
            raise ValueError("a source lies outside the central 75%")
        model[py, px] += flux
    return model
