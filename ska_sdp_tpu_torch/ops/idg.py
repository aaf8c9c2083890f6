"""Image-domain gridding helpers (port of ``ska_sdp_tpu/ops/idg.py``): the
Kaiser subgrid taper, its fine-grid divisor, the padded-FOV plan (both
directions), the centred DFT matrix, and the tapered w-kernel bank whose
exact scatter is IDG's operator.

IDG multiplies every subgrid image by a separable taper ``t(l)·t(m)`` and
divides the final dirty image by the taper's band-limited interpolation
onto the fine grid (every subgrid shares the same taper, so it factors out
of the whole image).  The taper is built in float64 and cast at the end.
"""

from __future__ import annotations

import math

import torch

from ..config import KernelOptions
from .fourier import ifft_centered, pad_mid
from .wkernel import extract_oversampled, kernel_coordinates, w_kernel_function


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


def tapered_w_bank(theta: float, w_centers, opts: KernelOptions,
                   taper_beta: float, subgrid: int, dtype=torch.float64,
                   device=None) -> torch.Tensor:
    """Conjugated oversampled bank ``[nw, qpx, qpx, s, s]`` of the tapered
    screen ``t(l)·t(m)·e^{2πi·w·n(l, m)}``: the bank whose exact scatter
    is IDG's effective kernel at the same β (``ops.wkernel.w_kernel_bank``'s
    pipeline with the Kaiser taper of l/θ multiplied into the far-field
    screen).  ``subgrid`` names the IDG subgrid the bank stands beside, as
    in the reference's signature: the analytic window depends on l/θ
    alone, so the bank is the same at every S.  Built on ``device`` in
    ``dtype``'s precision."""
    l, m = kernel_coordinates(opts.npix_ff, theta, opts, dtype=dtype,
                              device=device)
    ff = w_kernel_function(l, m, torch.as_tensor(w_centers, device=device))
    x = l[0] / theta * 2.0                       # in [-1, 1)
    t1 = torch.special.i0(taper_beta * torch.sqrt(
        torch.clamp(1.0 - x * x, 0.0, 1.0)))
    t1 = t1 / torch.special.i0(torch.tensor(taper_beta, dtype=torch.float64,
                                            device=device))
    ff = ff * (t1[None, :] * t1[:, None]).to(ff.dtype)
    af = ifft_centered(pad_mid(ff, opts.npix_ff * opts.qpx))
    return torch.conj(extract_oversampled(af, opts.qpx, opts.npix_kern)
                      ).resolve_conj()
