"""w-kernel synthesis: phase screen → oversampled gridding kernel (port of
``ska_sdp_tpu/ops/wkernel.py``).

  ``kernel_coordinates``  image-plane (l, m) grids, with the options'
                          pattern transform and shift
  ``w_kernel_function``   far-field screen e^{2πi·w·(1 − √(1 − l² − m²))}
  ``extract_oversampled`` the qpx×qpx oversampled taps, × qpx²
  ``w_kernel``            screen → zero-pad ×qpx → centred iFFT → taps
  ``w_kernel_bank``       the conjugated bank the gridder applies directly,
                          in span ``sdp.wkernel``

Everything is batched over a vector of w values on the leading axis, so a
whole bank is one batched call on whatever device ``device`` names.
"""

from __future__ import annotations

import math

import torch

from ..config import KernelOptions
from ..utils.timing import span
from .fourier import ifft_centered, pad_mid

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def kernel_coordinates(n: int, theta: float,
                       opts: KernelOptions | None = None,
                       dtype=torch.float64, device=None):
    """Image-plane ``(l, m)`` grids ``[n, n]`` scaled by ``theta``: ``l``
    varies along x (the last axis), ``m`` along y.  ``opts``' 2×2
    row-major ``pat_trans_mat`` T, when set, maps them to
    ``(T00·l + T10·m, T01·l + T11·m)``; then ``pat_hor_shift`` is added to
    l and ``pat_ver_shift`` to m."""
    base = (torch.arange(n, dtype=dtype, device=device) - n // 2) / n
    l = base[None, :].expand(n, n) * theta
    m = base[:, None].expand(n, n) * theta
    if opts is None:
        return l, m
    if opts.pat_trans_mat is not None:
        t = torch.as_tensor(opts.pat_trans_mat, dtype=dtype,
                            device=device).reshape(2, 2)
        l, m = t[0, 0] * l + t[1, 0] * m, t[0, 1] * l + t[1, 1] * m
    if opts.pat_hor_shift or opts.pat_ver_shift:
        l = l + opts.pat_hor_shift
        m = m + opts.pat_ver_shift
    return l, m


def w_kernel_function(l: torch.Tensor, m: torch.Tensor, w) -> torch.Tensor:
    """Far-field phase screen ``exp(2πi·w·(1 − √(1 − l² − m²)))``; a
    vector ``w`` adds leading axes (``[nw] → [nw, n, n]``)."""
    ph = 1.0 - torch.sqrt(1.0 - (l * l + m * m))
    w = torch.as_tensor(w, dtype=l.dtype, device=l.device)
    wph = w.reshape(w.shape + (1, 1)) * ph
    angle = (2.0 * math.pi) * wph
    return torch.polar(torch.ones_like(angle), angle).to(_COMPLEX[l.dtype])


def extract_oversampled(a: torch.Tensor, qpx: int, n: int) -> torch.Tensor:
    """``out[…, yf, xf, y, x] = a[…, c − yf + qpx·y, c − xf + qpx·x]·qpx²``
    with ``c = na/2 − qpx·(n/2)``: ``[…, na, na] → […, qpx, qpx, n, n]``."""
    na = a.shape[-1]
    cons = na // 2 - qpx * (n // 2)
    f = torch.arange(qpx, device=a.device)
    y = torch.arange(n, device=a.device)
    rows = cons - f[:, None] + qpx * y[None, :]            # [qpx, n]
    out = a[..., rows, :][..., rows]                        # […, qpx, n, qpx, n]
    return out.movedim(-2, -3) * (qpx * qpx)


def w_kernel(theta: float, w, opts: KernelOptions, dtype=torch.float64,
             device=None) -> torch.Tensor:
    """Oversampled w-kernel(s): ``[qpx, qpx, s, s]`` for a scalar ``w``,
    ``[nw, qpx, qpx, s, s]`` for a vector, complex of ``dtype``'s width.

    The screen on an ``npix_ff``² far field is zero-padded to
    ``npix_ff·qpx``, inverse-transformed (centred) and sampled at the
    oversampled tap positions."""
    l, m = kernel_coordinates(opts.npix_ff, theta, opts, dtype=dtype,
                              device=device)
    ff = w_kernel_function(l, m, w)
    af = ifft_centered(pad_mid(ff, opts.npix_ff * opts.qpx))
    return extract_oversampled(af, opts.qpx, opts.npix_kern)


def w_kernel_bank(theta: float, w_centers, opts: KernelOptions,
                  dtype=torch.float64, device=None) -> torch.Tensor:
    """The conjugated bank ``[nw, qpx, qpx, s, s]`` for the bank gridder
    (the reference conjugates each plane when it builds the bank), built in
    span ``sdp.wkernel``."""
    with span("sdp.wkernel"):
        return torch.conj(w_kernel(theta, w_centers, opts, dtype=dtype,
                                   device=device)).resolve_conj()
