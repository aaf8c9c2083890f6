"""PSF-normalised w-cache imaging (the reference CLI's ``--mode wcache``:
crocodile's ``w_cache_imaging`` under ``do_imaging``; ``psf_image``),
written again from the operator (w-projection of Cornwell, Golap &
Bhatnagar 2008, IEEE JSTSP 2, 647).

The baselines with v < 0 are mirrored first, and the uniform weights are
taken on the mirrored uvw (``do_imaging`` weights after mirroring, where
the other imaging entries weight before).  Each mirrored w falls in the
w-cache bin ``k = round(w / wstep)`` (float32, half to even), clipped to
the bins of ``w_range`` (its ends rounded the same way, in float64).
Each bin's kernel is
synthesised from its centre ``k·wstep`` by the formula, in float32: the
far-field screen ``e^{2πi·w·(1 − √(1 − l² − m²))}`` on ``npix_ff``²
coordinates ``l = (x − npix_ff/2)/npix_ff·θ`` (``l`` along x, ``m`` along
y), zero-padded to ``npix_ff·qpx``, centred inverse FFT, the oversampled
taps ``a[c − yf + qpx·y, c − xf + qpx·x]·qpx²`` with ``c = npix_ff·qpx/2 −
qpx·(s//2)``, conjugated.  A record lies in a cell with an oversampling
fraction as :mod:`.wproj` places it; the weighted visibilities, and the
weights alone, are scattered through the conjugated kernel onto two grids,
each completed Hermitian and transformed by the centred inverse FFT; both
real parts are divided by the PSF's peak.  Nothing is dropped.

Departures from the reference's own code, none in what is computed: the
bins are counted as integers ``k − k_min`` where the program takes
``(k·wstep − minw) // wstep`` in float64 (equal wherever ``k·wstep`` is
exact, as for every integer ``wstep`` here); the planes are synthesised a
few at a time, once for the image and the PSF together, where the program
builds its whole bank for each; the clamp of the fractions into
``[0, qpx)`` is the reference's, for fractions no input here holds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import (exact, full_f32, grid_size, hermitian, ifft2c,
                     mirrored, uniform_weights, wavelengths)
from .wproj import _cells, _chunk, placement

PLANES_A_STEP = 4


def _ends(cfg: dict):
    """The bins ``(k_min, k_max)`` of the configuration's ``w_range``."""
    wstep = float(cfg["wstep"])
    lo, hi = (int(np.round(float(x) / wstep)) for x in cfg["w_range"])
    return lo, hi


def planes(cfg: dict) -> int:
    """The planes of one bank: the bins of ``w_range``."""
    lo, hi = _ends(cfg)
    return hi - lo + 1


def w_planes(centres: torch.Tensor, cfg: dict, device, rnd=exact):
    """``[nw, qpx, qpx, s, s]`` complex64 conjugated kernels of the float32
    w values ``centres``."""
    n0, qpx, s = cfg["npix_ff"], cfg["qpx"], cfg["support"]
    theta = cfg["theta"]
    f32 = torch.float32
    x = (torch.arange(n0, dtype=f32, device=device) - n0 // 2) / n0
    l = (x * theta)[None, :]
    m = (x * theta)[:, None]
    ph = 1.0 - torch.sqrt(1.0 - (l * l + m * m))
    na = n0 * qpx
    lo = na // 2 - n0 // 2
    c = na // 2 - qpx * (s // 2)
    f = torch.arange(qpx, device=device)
    rows = c - f[:, None] + qpx * torch.arange(s, device=device)[None, :]
    out = []
    for p0 in range(0, centres.shape[0], PLANES_A_STEP):
        w = centres[p0:p0 + PLANES_A_STEP].to(f32)
        ang = (2.0 * math.pi) * (w[:, None, None] * ph[None])
        screen = torch.polar(torch.ones_like(ang), ang)
        pad = torch.zeros((w.shape[0], na, na), dtype=torch.complex64,
                          device=device)
        pad[:, lo:lo + n0, lo:lo + n0] = rnd(screen)
        a = ifft2c(pad)
        taps = a[:, rows][:, :, :, rows]          # [w, yf, y, xf, x]
        out.append(taps.permute(0, 1, 3, 2, 4) * (qpx * qpx))
    return torch.conj(torch.cat(out)).resolve_conj()


def _scatter(v, kern, b, yf, xf, y0, x0, s: int, N: int, device):
    out = torch.zeros((N * N, 2), dtype=torch.float32, device=device)
    step = _chunk(s, s, device)
    for c0 in range(0, v.shape[0], step):
        sl = slice(c0, c0 + step)
        cells, inb = _cells(y0[sl], x0[sl], s, s, N)
        patch = torch.where(inb, v[sl, None, None] * kern[b[sl], yf[sl],
                                                          xf[sl]], 0)
        out.index_add_(0, cells.reshape(-1),
                       torch.view_as_real(patch).reshape(-1, 2))
    return torch.view_as_complex(out).reshape(N, N)


def image(req: dict, cfg: dict, device, rnd=exact):
    """``{"image": [N, N] float32 ÷ PSF peak, "psf": the PSF ÷ its peak,
    "pmax": the peak, "dropped": 0}`` (``psf_image``, mode
    ``wcache``)."""
    N, qpx, s = grid_size(cfg), cfg["qpx"], cfg["support"]
    vis = torch.as_tensor(np.asarray(req["vis"], np.complex64),
                          device=device)
    uvw_m, vis_m = mirrored(wavelengths(req, device), vis)
    wt = uniform_weights(uvw_m, cfg).to(torch.complex64)
    wstep = float(cfg["wstep"])
    lo, hi = _ends(cfg)
    b = torch.round(uvw_m[:, 2] / wstep).to(torch.int64).clamp(lo, hi) - lo
    centres = (torch.arange(lo, hi + 1, dtype=torch.float64, device=device)
               * wstep).to(torch.float32)
    y0, x0, yf, xf = placement(uvw_m / cfg["lam"], N, qpx, s, s)
    yf, xf = yf.clamp(0, qpx - 1), xf.clamp(0, qpx - 1)
    with full_f32():
        kern = rnd(w_planes(centres, cfg, device, rnd))
        grids = [_scatter(rnd(v), kern, b, yf, xf, y0, x0, s, N, device)
                 for v in (vis_m * wt, wt)]
        drt, psf = (ifft2c(rnd(hermitian(g))).real for g in grids)
    pmax = torch.max(psf)
    return {"image": drt / pmax, "psf": psf / pmax, "pmax": pmax,
            "dropped": 0}


def taps(req: dict, cfg: dict, device) -> int:
    """Patch cells inside the grid over all mirrored records, from the
    configuration's ``qpx`` and ``support``: the least count of one
    scatter's work, for the roofline."""
    N, qpx, s = grid_size(cfg), cfg["qpx"], cfg["support"]
    uvw_l = wavelengths(req, device)
    uvw_l = torch.where((uvw_l[:, 1] < 0)[:, None], -uvw_l, uvw_l)
    y0, x0, _, _ = placement(uvw_l / cfg["lam"], N, qpx, s, s)
    ny = (torch.clamp(y0 + s, max=N) - torch.clamp(y0, min=0)).clamp(min=0)
    nx = (torch.clamp(x0 + s, max=N) - torch.clamp(x0, min=0)).clamp(min=0)
    return int(torch.sum(ny * nx))
