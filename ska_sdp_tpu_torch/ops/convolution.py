"""Centred 2-D convolution of small kernels and the AW-kernel algebra (port
of ``ska_sdp_tpu/ops/convolution.py``).

``convolve2d(a, b)`` pads both ``s×s`` kernels to the power of two
``m ≥ 2s − 1``, takes each one's centred analysis spectrum, multiplies the
spectra, synthesises back, keeps the middle ``s×s`` and scales by ``m²``.
The AW kernel of a visibility is ``convolve2d(convolve2d(A[a1], A[a2]),
W[wbin, yf, xf])``; the truncation to ``s`` between the two convolutions is
part of the semantics, so both stages are kept.

For ``m ≤ 128`` the centred transforms are dense matrix sandwiches
``M · x · Mᵀ`` with the analysis matrix ``(m, s)`` and the synthesis matrix
``(s, m)`` (the same operators as the FFTs, another factorisation); above
that the FFT is used.  The matrices are numpy complex128, built once per
size.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .fourier import extract_mid, next_pow2, pad_mid

_MM_MAX = 128   # matrix sandwiches for transforms up to this size
_AX = (-2, -1)


@lru_cache(maxsize=None)
def _analysis_mat(s: int, m: int) -> np.ndarray:
    """``A`` ``(m, s)`` with ``_spec(x, m) == A @ x @ A.T`` for ``(s, s)``
    inputs: centred zero-pad, inverse shift, inverse DFT (÷m per axis)."""
    j = np.arange(s)
    p = (j - s // 2) % m
    k = np.arange(m)[:, None]
    return np.exp(2j * np.pi * k * p[None, :] / m) / m


@lru_cache(maxsize=None)
def _synthesis_mat(n: int, m: int) -> np.ndarray:
    """``S`` ``(n, m)`` with ``_synth(X, n, m) == S @ X @ S.T`` for
    ``(m, m)`` spectra: DFT, shift, middle ``n``, the ``m²`` scale split
    ``m`` per axis."""
    i = np.arange(n)
    rows = (i - n // 2) % m
    l = np.arange(m)[None, :]
    return np.exp(-2j * np.pi * rows[:, None] * l / m) * m


def _sandwich(M, x: torch.Tensor) -> torch.Tensor:
    """``M @ x @ M.T`` batched over the leading axes of ``x``, in the
    complex type of ``x`` (complex64 at least)."""
    dt = torch.promote_types(x.dtype, torch.complex64)
    M = torch.as_tensor(M, device=x.device).to(dt)
    return torch.matmul(torch.matmul(M, x.to(dt)), M.transpose(0, 1))


def _spec(a: torch.Tensor, m: int) -> torch.Tensor:
    """Centred analysis transform ``ifft ∘ ishift ∘ pad`` to ``(m, m)``."""
    s = a.shape[-1]
    if m <= _MM_MAX:
        return _sandwich(_analysis_mat(s, m), a)
    return torch.fft.ifft2(torch.fft.ifftshift(pad_mid(a, m), dim=_AX))


def _synth(spec: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Centred synthesis ``shift ∘ fft``, middle ``n``, ×m²."""
    if m <= _MM_MAX:
        return _sandwich(_synthesis_mat(n, m), spec)
    conv = torch.fft.fftshift(torch.fft.fft2(spec), dim=_AX)
    return extract_mid(conv, n) * (m * m)


def convolve2d(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """Centred linear convolution of equal-size square kernels, batched
    over broadcasting leading axes (pad to ``next_pow2(2s − 1)``)."""
    n = a1.shape[-1]
    m = next_pow2(2 * n - 1)
    return _synth(_spec(a1, m) * _spec(a2, m), n, m)


def convolve2d_cheap(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """Circular variant padded only to ``next_pow2(s)``: wrap-around
    aliasing accepted for a smaller transform."""
    n = a1.shape[-1]
    m = next_pow2(n)
    return _synth(_spec(a1, m) * _spec(a2, m), n, m)


def aw_kernel(a1_kern: torch.Tensor, a2_kern: torch.Tensor,
              w_tap: torch.Tensor) -> torch.Tensor:
    """``convolve2d(convolve2d(a1, a2), w_tap)``; inputs ``[..., s, s]``."""
    return convolve2d(convolve2d(a1_kern, a2_kern), w_tap)


def akernel_spectra(akerns: torch.Tensor) -> torch.Tensor:
    """Analysis spectra ``[nant, m, m]`` of the A-kernels ``[nant, s, s]``
    (``m = next_pow2(2s − 1)``)."""
    s = akerns.shape[-1]
    return _spec(akerns, next_pow2(2 * s - 1))


def wkernel_tap_spectra(wkerns: torch.Tensor) -> torch.Tensor:
    """Analysis spectra ``[nw, qpx, qpx, m, m]`` of every oversampled
    w-kernel tap ``[nw, qpx, qpx, s, s]``."""
    s = wkerns.shape[-1]
    return _spec(wkerns, next_pow2(2 * s - 1))


def pair_transfer(s: int, m: int) -> np.ndarray:
    """``T = A @ S`` ``(m, m)``: ``_spec ∘ _synth(·, s)`` as one rank-``s``
    sandwich; the truncation to ``s`` is inside."""
    return _analysis_mat(s, m) @ _synthesis_mat(s, m)


def make_aw_kernels_batched(s: int):
    """A builder of conjugated AW kernels from precomputed spectra:

        build(a_spec [nant, m, m], w_spec [nw, qpx, qpx, m, m],
              a1, a2, wbin, yf, xf [b]) → [b, s, s]
            = conj(convolve2d(convolve2d(A[a1], A[a2]), W[wbin, yf, xf]))
    """
    m = next_pow2(2 * s - 1)

    def build(a_spec, w_spec, a1_idx, a2_idx, wbin, yf, xf):
        prod1 = a_spec[a1_idx.long()] * a_spec[a2_idx.long()]
        if m <= _MM_MAX:
            aspec2 = _sandwich(pair_transfer(s, m), prod1)
        else:
            aspec2 = _spec(_synth(prod1, s, m), m)
        wtap = w_spec[wbin.long(), yf.long(), xf.long()]
        return torch.conj(_synth(aspec2 * wtap, s, m)).resolve_conj()

    return build
