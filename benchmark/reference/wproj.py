"""Bank w-projection imaging and prediction (the reference's ``convgrid2``
and its adjoint), written again from the operator.

A record at ``x = N/2 + (u/lam)·N`` lies in cell ``⌊x + 1/(2·qpx)⌋`` with
oversampling fraction ``round((x − cell)·qpx)`` (and so in v); its kernel
is the bank plane closest to its w (ties to the higher plane), at that
fraction pair, a ``gh``×``gw`` patch whose corner sits ``gh/2`` and
``gw/2`` cells before the record's cell.  Imaging adds the weighted,
mirrored visibility times the conjugated kernel to every patch cell
inside the grid, completes the grid Hermitian and takes the centred
inverse FFT; prediction reads ``Σ conj(K)·window`` from the model's
centred FFT at the unmirrored baseline.  Nothing is dropped on this path.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import (exact, fft2c, grid_size, hermitian, ifft2c,
                     wavelengths, weighted_mirrored)


def closest_plane(centers: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int64 index of the closest centre; outside the range the nearest
    end, exact ties the higher index."""
    n = centers.shape[0]
    hi = torch.clamp(torch.searchsorted(centers, w.contiguous(), right=True),
                     1, n - 1)
    lo = hi - 1
    return torch.where(torch.abs(w - centers[lo]) < torch.abs(w - centers[hi]),
                       lo, hi)


def placement(p: torch.Tensor, N: int, qpx: int, gh: int, gw: int):
    """``(y0, x0, yf, xf)`` int64: patch corners and fractions."""
    out = []
    for ax in (1, 0):
        x = N // 2 + p[:, ax] * N
        cell = torch.floor(x + 0.5 / qpx)
        frac = torch.round((x - cell) * qpx)
        out += [cell.long(), frac.long()]
    y, yf, x, xf = out
    return y - gh // 2, x - gw // 2, yf, xf


def _inputs(req: dict, p: torch.Tensor, w: torch.Tensor, N: int):
    bank = torch.as_tensor(req["wkerns"], device=p.device)
    nw, qpx, _, gh, gw = bank.shape
    centers = torch.as_tensor(np.asarray(req["wbins"]), dtype=torch.float32,
                              device=p.device)
    wbin = closest_plane(centers, w)
    y0, x0, yf, xf = placement(p, N, qpx, gh, gw)
    taps = (wbin.clamp(0, nw - 1), yf.clamp(0, qpx - 1), xf.clamp(0, qpx - 1))
    return bank.to(torch.complex64), taps, y0, x0, gh, gw


def _cells(y0, x0, gh: int, gw: int, N: int):
    yy = y0[:, None, None] + torch.arange(gh, device=y0.device)[None, :, None]
    xx = x0[:, None, None] + torch.arange(gw, device=y0.device)[None, None, :]
    inb = (yy >= 0) & (yy < N) & (xx >= 0) & (xx < N)
    return torch.where(inb, yy * N + xx, 0), inb


def _chunk(gh: int, gw: int, device) -> int:
    return max(1, (2**24 if device.type == "cuda" else 2**20) // (gh * gw))


def image(req: dict, cfg: dict, device, rnd=exact):
    """``{"image": [N, N] float32, "dropped": 0}`` (``w_image``)."""
    N = grid_size(cfg)
    uvw_m, v = weighted_mirrored(req, cfg, device)
    bank, (b, yf, xf), y0, x0, gh, gw = _inputs(req, uvw_m / cfg["lam"],
                                                uvw_m[:, 2], N)
    kern = rnd(torch.conj(bank))
    v = rnd(v)
    out = torch.zeros((N * N, 2), dtype=torch.float32, device=device)
    step = _chunk(gh, gw, device)
    for c0 in range(0, v.shape[0], step):
        sl = slice(c0, c0 + step)
        cells, inb = _cells(y0[sl], x0[sl], gh, gw, N)
        patch = v[sl, None, None] * kern[b[sl], yf[sl], xf[sl]]
        patch = torch.where(inb, patch, 0)
        out.index_add_(0, cells.reshape(-1),
                       torch.view_as_real(patch).reshape(-1, 2))
    guv = torch.view_as_complex(out).reshape(N, N)
    return {"image": ifft2c(rnd(hermitian(guv))).real, "dropped": 0}


def predict(req: dict, cfg: dict, device, rnd=exact):
    """``{"vis": [n] complex64, "dropped": 0}`` (``w_predict_vis``)."""
    N = grid_size(cfg)
    model = torch.as_tensor(req["model"], dtype=torch.float32,
                            device=device)
    spec = rnd(fft2c(rnd(model.to(torch.complex64))).reshape(-1))
    uvw_l = wavelengths(req, device)
    bank, (b, yf, xf), y0, x0, gh, gw = _inputs(req, uvw_l / cfg["lam"],
                                                uvw_l[:, 2], N)
    kern = rnd(torch.conj(bank))
    n = uvw_l.shape[0]
    out = torch.empty((n,), dtype=torch.complex64, device=device)
    step = _chunk(gh, gw, device)
    for c0 in range(0, n, step):
        sl = slice(c0, c0 + step)
        cells, inb = _cells(y0[sl], x0[sl], gh, gw, N)
        win = torch.where(inb, spec[cells], 0)
        out[sl] = torch.sum(win * kern[b[sl], yf[sl], xf[sl]], dim=(-2, -1))
    return {"vis": out, "dropped": 0}


def taps(req: dict, cfg: dict, device, imaging: bool = True) -> int:
    """Patch cells inside the grid over all records: the least count of
    scatter (or gather) work, for the rooflines."""
    N = grid_size(cfg)
    uvw_l = wavelengths(req, device)
    if imaging:
        uvw_l = torch.where((uvw_l[:, 1] < 0)[:, None], -uvw_l, uvw_l)
    bank = torch.as_tensor(req["wkerns"])
    _, qpx, _, gh, gw = bank.shape
    y0, x0, _, _ = placement(uvw_l / cfg["lam"], N, qpx, gh, gw)
    ny = (torch.clamp(y0 + gh, max=N) - torch.clamp(y0, min=0)).clamp(min=0)
    nx = (torch.clamp(x0 + gw, max=N) - torch.clamp(x0, min=0)).clamp(min=0)
    return int(torch.sum(ny * nx))
