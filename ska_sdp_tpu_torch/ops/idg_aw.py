"""IDG-AW geometry shared by the run prep and the gridder (port of
``ska_sdp_tpu/ops/idg_aw.py``): the taper-tail fit margin, image-domain
antenna screens (on the stamps' device, and their numpy twin), and the
per-record (pair, uv-tile) keys.

Records are grouped into runs that share one antenna pair and one coarse
uv tile of side ``Tc = max(2·margin − 2, 8)``.  A run's subgrid origin is a
pure function of its tile id, so the prep, the CUDA kernel and its plain
version all place a run at the same cell.  Records whose support does not
fit their tile's subgrid are dropped and counted.
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = 2**30        # pair key of records that are never gridded
PAIR_SHIFT = 2**15      # pair key = a1·2¹⁵ + a2


def auto_fit_margin(S: int, support: int) -> int:
    """Taper-tail fit margin ``S/2 − support/2 − taper(S)``; the Kaiser
    taper's decay region is a fixed fraction (12/64) of the subgrid."""
    return S // 2 - support // 2 - max(6, (12 * S) // 64)


def aw_screens_host(akerns, S: int, fov_scale: float = 1.0) -> np.ndarray:
    """Image-domain antenna screens ``[nant, S, S]`` (complex128, numpy)
    from uv-domain A-kernel stamps ``[nant, s, s]``:
    ``a(l_q, m_r) = Σ ak[j, i]·e^{−2πi·fov_scale·[(j−s/2)(q−S/2) +
    (i−s/2)(r−S/2)]/S}``; a delta stamp gives the unit screen.  The
    gridder applies the conjugated pair product ``conj(a1·a2)``."""
    ak = np.asarray(akerns)
    s = ak.shape[-1]
    j = np.arange(s) - s // 2
    q = np.arange(S) - S // 2
    E = np.exp(-2j * np.pi * fov_scale / S * np.outer(q, j))
    return E @ ak @ E.T                  # Σ_jk E[q, j]·ak[a, j, k]·E[r, k]


def aw_screens(akerns: torch.Tensor, S: int, fov_scale: float = 1.0,
               dtype=torch.complex64) -> torch.Tensor:
    """The screens of :func:`aw_screens_host` on ``akerns``' device: the
    stamps as given, the phase matrix ``E`` ``[S, s]`` and the two
    products ``E·ak·Eᵀ`` in complex128, then the cast to ``dtype``."""
    ak = akerns.to(torch.complex128)
    s = ak.shape[-1]
    j = torch.arange(s, dtype=torch.float64, device=ak.device) - s // 2
    q = torch.arange(S, dtype=torch.float64, device=ak.device) - S // 2
    phase = (-2 * np.pi * fov_scale / S) * torch.outer(q, j)
    E = torch.polar(torch.ones_like(phase), phase)
    return (E @ ak @ E.T).to(dtype)


def _record_keys(grid_shape, p: torch.Tensor, a1: torch.Tensor,
                 a2: torch.Tensor, subgrid: int, support: int,
                 fit_margin: int):
    """Per-record sort keys and offsets.

    ``p`` is ``[n, 3]`` float32; the padded grid is ``HP = N + 2S`` by
    ``WP = Nx + 2S``.  Records that are out of bounds or unfit carry the
    pair key :data:`SENTINEL`, so they form tail runs that are never
    gridded.  Returns ``(pkey, tkey, dy, dx, valid, fit, Tc, ntx_t, HP,
    WP)`` with int32 keys and float32 offsets.
    """
    N, Nx = grid_shape
    S = subgrid
    s = support
    if fit_margin == 0:
        fit_margin = auto_fit_margin(S, s)
    if fit_margin <= 0:
        raise ValueError("subgrid too small for support + taper margin")
    PADM = S
    HP, WP = N + 2 * PADM, Nx + 2 * PADM
    i32 = torch.int32

    ycf = (N // 2 + p[:, 1] * N + PADM).to(torch.float32)
    xcf = (Nx // 2 + p[:, 0] * Nx + PADM).to(torch.float32)
    yc = torch.floor(ycf - PADM + 0.5).to(i32)
    xc = torch.floor(xcf - PADM + 0.5).to(i32)
    valid = ((yc - s // 2 > -s) & (yc - s // 2 < N)
             & (xc - s // 2 > -s) & (xc - s // 2 < Nx))
    # ids at or past 2¹⁵ would corrupt the pair key: drop and count them
    ant_ok = (a1 >= 0) & (a1 < PAIR_SHIFT) & (a2 >= 0) & (a2 < PAIR_SHIFT)

    Tc = max(2 * fit_margin - 2, 8)
    ty = torch.clamp(ycf, 0, HP - 1).to(i32) // Tc
    tx = torch.clamp(xcf, 0, WP - 1).to(i32) // Tc
    ntx_t = WP // Tc + 1
    tkey = ty * ntx_t + tx

    y0r = torch.clamp(ty * Tc - (S - Tc) // 2, 0, HP - S)
    x0r = torch.clamp(tx * Tc - (S - Tc) // 2, 0, WP - S)
    dy = ycf - (y0r.to(torch.float32) + S // 2)
    dx = xcf - (x0r.to(torch.float32) + S // 2)
    fit = ((torch.abs(dy) <= fit_margin) & (torch.abs(dx) <= fit_margin)
           & ant_ok)
    pkey = torch.where(valid & fit,
                       a1.to(i32) * PAIR_SHIFT + a2.to(i32),
                       torch.full_like(tkey, SENTINEL))
    return pkey, tkey, dy, dx, valid, fit, Tc, ntx_t, HP, WP
