"""Nearest-cell, fixed-kernel and bank w-projection scatters, the bank
gather and the AW-projection scatter in plain PyTorch (port of
``grid_nearest``, ``convgrid``, ``convgrid_wproj``, ``degrid_wproj`` and
``convgrid_aw`` of ``ska_sdp_tpu/ops/gridding.py``, the reference's
``grid``, ``convgrid``, ``convgrid2``, its adjoint, and ``convgrid4``).

Each visibility's tap plane ``K_b = bank[wbin_b, yf_b, xf_b]`` (``[gh, gw]``)
sits with its top-left corner at ``(y_b − gh//2, x_b − gw//2)``, where
``(x, xf, y, yf) = frac_coords(p)``:

    scatter:  grid[y0 + i, x0 + j] += vis_b · K_b[i, j]
    gather:   vis_b = Σ_{i,j} conj(K_b[i, j]) · grid[y0 + i, x0 + j]

Cells outside ``[0, H) × [0, W)`` are dropped on scatter and read as 0 on
gather (the reference's ``fixoutofbounds``).  Visibilities go in chunks of
``chunk``, so the temporaries stay ``O(chunk · gh · gw)``.  These are the
plain versions of the CUDA kernels ``csrc/wproj_grid.cu`` and
``csrc/wproj_degrid.cu``: the CPU path and the yardstick the kernels are
checked against.  ``convgrid`` is the bank scatter with a one-plane
bank; ``grid_nearest`` adds each visibility to one cell.  ``convgrid_aw``
builds each visibility's AW kernel
from the A-kernel and w-tap spectra (``ops/convolution.py``) and places
it the same way; it is the CPU route of ``kernels.aw_gridder``.
"""

from __future__ import annotations

import torch

from .convolution import (akernel_spectra, make_aw_kernels_batched,
                          wkernel_tap_spectra)
from .coords import frac_coords, to_grid_cell

DEFAULT_CHUNK = 8192


def _patch_cells(y0, x0, gh: int, gw: int, H: int, W: int):
    """Flat cell indices ``[c, gh, gw]`` of each patch (0 where out of
    bounds) and the in-bounds mask."""
    di = torch.arange(gh, device=y0.device)
    dj = torch.arange(gw, device=y0.device)
    yy = y0.long()[:, None, None] + di[None, :, None]
    xx = x0.long()[:, None, None] + dj[None, None, :]
    inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    return torch.where(inb, yy * W + xx, 0), inb


def _taps(bank, wbin, yf, xf):
    """``bank[wbin, yf, xf]`` with each index held inside its axis."""
    nw, qpx = bank.shape[0], bank.shape[1]
    return bank[wbin.long().clamp(0, nw - 1), yf.long().clamp(0, qpx - 1),
                xf.long().clamp(0, qpx - 1)]


def _placement(bank, shape_hw, p):
    nw, qpx, _, gh, gw = bank.shape
    x, xf, y, yf = frac_coords(shape_hw, qpx, p)
    return y - gh // 2, x - gw // 2, yf, xf, gh, gw


def grid_nearest(guv: torch.Tensor, p: torch.Tensor,
                 vis: torch.Tensor) -> torch.Tensor:
    """Nearest-cell scatter onto a copy of ``guv`` ``[H, W]``:
    ``grid[cell(v), cell(u)] += vis`` with :func:`to_grid_cell`'s round-half-
    up cells; visibilities off the grid are dropped."""
    H, W = guv.shape
    y = to_grid_cell(H, p[:, 1]).long()
    x = to_grid_cell(W, p[:, 0]).long()
    inb = (y >= 0) & (y < H) & (x >= 0) & (x < W)
    out = guv.clone()
    torch.view_as_real(out).view(-1, 2).index_add_(
        0, torch.where(inb, y * W + x, 0),
        torch.view_as_real(torch.where(inb, vis, 0).to(out.dtype)))
    return out


def convgrid(gcf: torch.Tensor, guv: torch.Tensor, p: torch.Tensor,
             vis: torch.Tensor, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Scatter through one oversampled kernel ``[qpx, qpx, gh, gw]`` (taken
    as given): :func:`convgrid_wproj` with the one-plane bank ``gcf[None]``
    and every record on plane 0."""
    wbin = torch.zeros((p.shape[0],), dtype=torch.int32, device=p.device)
    return convgrid_wproj(gcf[None], guv, p, wbin, vis, chunk=chunk)


def convgrid_wproj(gcf_bank: torch.Tensor, guv: torch.Tensor,
                   p: torch.Tensor, wbin: torch.Tensor, vis: torch.Tensor,
                   chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Scatter ``vis`` through the ``[nw, qpx, qpx, gh, gw]`` bank (taken
    as given: the bank gridder's bank is pre-conjugated) onto a copy of
    ``guv`` ``[H, W]``; returns the new grid, of ``guv``'s dtype."""
    H, W = guv.shape
    y0, x0, yf, xf, gh, gw = _placement(gcf_bank, (H, W), p)
    out = guv.clone()
    flat = torch.view_as_real(out).view(-1, 2)
    for c0 in range(0, vis.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        idx, inb = _patch_cells(y0[sl], x0[sl], gh, gw, H, W)
        patch = vis[sl, None, None] * _taps(gcf_bank, wbin[sl], yf[sl],
                                            xf[sl])
        patch = torch.where(inb, patch, 0).to(out.dtype)
        flat.index_add_(0, idx.reshape(-1),
                        torch.view_as_real(patch).reshape(-1, 2))
    return out


def degrid_wproj(gcf_bank: torch.Tensor, grid: torch.Tensor,
                 p: torch.Tensor, wbin: torch.Tensor,
                 chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Adjoint of :func:`convgrid_wproj` for the same (raw) bank: the
    ``[n]`` visibilities ``Σ conj(K_b)·window_b`` from the ``[H, W]``
    grid."""
    H, W = grid.shape
    y0, x0, yf, xf, gh, gw = _placement(gcf_bank, (H, W), p)
    n = p.shape[0]
    dtype = torch.promote_types(grid.dtype, gcf_bank.dtype)
    out = torch.empty((n,), dtype=dtype, device=grid.device)
    flat = grid.reshape(-1)
    for c0 in range(0, n, chunk):
        sl = slice(c0, c0 + chunk)
        idx, inb = _patch_cells(y0[sl], x0[sl], gh, gw, H, W)
        win = torch.where(inb, flat[idx], 0)
        taps = _taps(gcf_bank, wbin[sl], yf[sl], xf[sl])
        out[sl] = torch.sum(win * taps.conj(), dim=(-2, -1))
    return out


def convgrid_aw(wkerns: torch.Tensor, akerns: torch.Tensor,
                guv: torch.Tensor, p: torch.Tensor, wbin: torch.Tensor,
                a1: torch.Tensor, a2: torch.Tensor, vis: torch.Tensor,
                chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """AW-projection scatter onto a copy of ``guv`` ``[H, W]``: visibility
    b adds ``vis_b · conj(A[a1_b] ⊛ A[a2_b] ⊛ W[wbin_b, yf_b, xf_b])``
    with the unconjugated w-kernel bank ``wkerns`` ``[nw, qpx, qpx, s, s]``
    and the A-kernels ``akerns`` ``[nant, s, s]``, each kernel built from
    the spectra per visibility in chunks of ``chunk``."""
    nw, qpx, _, gh, gw = wkerns.shape
    H, W = guv.shape
    x, xf, y, yf = frac_coords((H, W), qpx, p)
    y0, x0 = y - gh // 2, x - gw // 2
    a_spec = akernel_spectra(akerns)
    w_spec = wkernel_tap_spectra(wkerns)
    build = make_aw_kernels_batched(gh)
    out = guv.clone()
    flat = torch.view_as_real(out).view(-1, 2)
    for c0 in range(0, vis.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        idx, inb = _patch_cells(y0[sl], x0[sl], gh, gw, H, W)
        awk = build(a_spec, w_spec, a1[sl], a2[sl], wbin[sl], yf[sl], xf[sl])
        patch = torch.where(inb, vis[sl, None, None] * awk, 0).to(out.dtype)
        flat.index_add_(0, idx.reshape(-1),
                        torch.view_as_real(patch).reshape(-1, 2))
    return out
