"""Centred FFTs, padding and extraction (port of
``ska_sdp_tpu/ops/fourier.py``), on ``torch.fft``.  Every transform acts
on the last two axes."""

from __future__ import annotations

import torch

_AX = (-2, -1)


def ifft_centered(grid: torch.Tensor) -> torch.Tensor:
    """Grid → image: ``fftshift(ifft2(ifftshift(g)))`` (1/N² scaling)."""
    return torch.fft.fftshift(
        torch.fft.ifft2(torch.fft.ifftshift(grid, dim=_AX)), dim=_AX)


def fft_centered(img: torch.Tensor) -> torch.Tensor:
    """Image → grid: ``fftshift(fft2(ifftshift(m)))``."""
    return torch.fft.fftshift(
        torch.fft.fft2(torch.fft.ifftshift(img, dim=_AX)), dim=_AX)


def pad_mid(ff: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad ``(…, n0, n0)`` to ``(…, n, n)``, centred: ``n//2 − n0//2``
    leading and ``(n+1)//2 − (n0+1)//2`` trailing on each axis."""
    n0 = ff.shape[-1]
    if n == n0:
        return ff
    lo = n // 2 - n0 // 2
    out = ff.new_zeros(ff.shape[:-2] + (n, n))
    out[..., lo:lo + n0, lo:lo + n0] = ff
    return out


def extract_mid(a: torch.Tensor, n: int) -> torch.Tensor:
    """The centred ``(…, n, n)`` section; inverse of :func:`pad_mid`."""
    cx = a.shape[-2] // 2
    cy = a.shape[-1] // 2
    s = n // 2
    return a[..., cx - s:cx - s + n, cy - s:cy - s + n]


def next_pow2(x: int) -> int:
    """Smallest power of two ≥ ``x``."""
    p = 1
    while p < x:
        p *= 2
    return p
