"""Image-domain gridding helpers (port of ``ska_sdp_tpu/ops/idg.py``): the
Kaiser subgrid taper, its fine-grid divisor, the padded-FOV plan (both
directions), the centred DFT matrix, and the overlap fold of half-overlapping
subgrids and its adjoint.

IDG multiplies every subgrid image by a separable taper ``t(l)·t(m)`` and
divides the final dirty image by the taper's band-limited interpolation
onto the fine grid (every subgrid shares the same taper, so it factors out
of the whole image).  The taper is built in float64 and cast at the end.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def kaiser_taper(S: int, beta: float, dtype=torch.float32, device=None):
    """Separable Kaiser taper on the S-point coarse grid:
    ``t[q] = I0(β√(1 − (2(q − S/2)/S)²)) / I0(β)``."""
    q = (torch.arange(S, dtype=torch.float64, device=device) - S // 2) \
        / (S / 2)
    t = torch.special.i0(beta * torch.sqrt(torch.clamp(1.0 - q * q, 0.0,
                                                       1.0)))
    i0b = torch.special.i0(torch.tensor(beta, dtype=torch.float64,
                                        device=device))
    return (t / i0b).to(dtype)


def taper_fine(N: int, S: int, taper_1d: torch.Tensor) -> torch.Tensor:
    """Fine-grid divisor for the final dirty image: the zero-padded centred
    DFT round-trip of the coarse S-point taper onto N points (float64)."""
    t = taper_1d.to(torch.complex128)
    spec = torch.fft.fftshift(torch.fft.fft(torch.fft.ifftshift(t)))
    lo = N // 2 - S // 2
    padded = torch.zeros((N,), dtype=torch.complex128, device=t.device)
    padded[lo:lo + S] = spec
    fine = torch.fft.fftshift(torch.fft.ifft(torch.fft.ifftshift(padded)))
    return fine.real * (N / S)


def idg_fov_pad_plan(N: int, fov_fraction: float):
    """Padded-FOV plan: grid at ``N′ = N/f`` (same pixel size, same parity
    as N) and crop the centre N pixels.  Returns ``(N_pad, crop_lo)``.

    The taper division amplifies error toward the image edge, so a plain
    image is accurate only inside ~75% of the FOV radius; ``f = 0.75``
    moves the whole target FOV into that interior."""
    if not (0.0 < fov_fraction <= 1.0):
        raise ValueError("fov_fraction must be in (0, 1]")
    extra = int(-(-N * (1.0 / fov_fraction - 1.0) // 2)) * 2
    return N + extra, extra // 2


def fov_pad_geometry(theta: float, lam: int, fov_pad):
    """``(n_target, n_grid, theta_grid, crop_lo)``; ``fov_pad=None`` is the
    plain FOV.  Keep :func:`fov_pad_finish` in sync."""
    n = int(round(theta * lam))
    if fov_pad is not None:
        n_grid, crop_lo = idg_fov_pad_plan(n, fov_pad)
        return n, n_grid, theta * n_grid / n, crop_lo
    return n, n, theta, 0


def fov_pad_finish(img: torch.Tensor, n: int, n_grid: int, crop_lo: int):
    """Rescale and centre-crop a padded-FOV image back to the target grid
    (the centred inverse FFT scales by 1/n_grid²)."""
    if n_grid == n:
        return img
    img = img * ((n_grid / n) ** 2)
    return img[crop_lo:crop_lo + n, crop_lo:crop_lo + n]


def fov_pad_start(img: torch.Tensor, n: int, n_grid: int, crop_lo: int):
    """Predict-direction companion of :func:`fov_pad_finish`: embed the
    target-FOV model image in the padded grid, zeros outside.  No
    rescale: the forward FFT is unnormalised, so each model pixel gives
    the same phase ramp whatever the grid size."""
    if n_grid == n:
        return img
    out = img.new_zeros((n_grid, n_grid))
    out[crop_lo:crop_lo + n, crop_lo:crop_lo + n] = img
    return out


def _dft_matrix(S: int, dtype=torch.complex64, device=None):
    """Centred forward DFT matrix ``F[y, q] = e^{−2πi(y − S/2)(q − S/2)/S}``,
    with phases at the precision the dtype implies."""
    ftype = torch.float64 if dtype == torch.complex128 else torch.float32
    k = torch.arange(S, dtype=ftype, device=device) - S // 2
    ph = -2.0 * math.pi * torch.outer(k, k) / S
    return torch.polar(torch.ones_like(ph), ph).to(dtype)


def _check_overlap(S: int, T: int) -> None:
    if S != 2 * T:
        raise ValueError(f"subgrids overlap by half: S must be 2T, got "
                         f"S={S}, T={T}")


def _fold_overlap(blocks: torch.Tensor, nty: int, ntx: int, S: int, T: int):
    """Overlap-add subgrid blocks ``[nty, ntx, S, S]`` (stride T, size
    S = 2T) into the padded grid ``[(nty + 1)·T, (ntx + 1)·T]``: four
    dense reshape-adds, one per quadrant of the blocks."""
    _check_overlap(S, T)
    g = blocks.new_zeros((nty + 1, T, ntx + 1, T))
    g[:nty, :, :ntx] += blocks[:, :, :T, :T].permute(0, 2, 1, 3)
    g[:nty, :, 1:] += blocks[:, :, :T, T:].permute(0, 2, 1, 3)
    g[1:, :, :ntx] += blocks[:, :, T:, :T].permute(0, 2, 1, 3)
    g[1:, :, 1:] += blocks[:, :, T:, T:].permute(0, 2, 1, 3)
    return g.reshape((nty + 1) * T, (ntx + 1) * T)


def _overlap_windows(gp: torch.Tensor, nty: int, S: int, T: int,
                     ntx: Optional[int] = None):
    """All S×S subgrid windows ``[nty, ntx, S, S]`` (stride T, S = 2T) of
    the padded grid: the adjoint of :func:`_fold_overlap`."""
    _check_overlap(S, T)
    if ntx is None:
        ntx = nty
    b = gp.reshape(nty + 1, T, ntx + 1, T).permute(0, 2, 1, 3)
    top = torch.cat([b[:nty, :ntx], b[:nty, 1:]], dim=-1)
    bot = torch.cat([b[1:, :ntx], b[1:, 1:]], dim=-1)
    return torch.cat([top, bot], dim=-2)
