"""The w-kernel bank the bank w-projection cells hand to the program and to
the reference: a frozen PyTorch copy of the port's synthesis
(``ska_sdp_tpu_torch/ops/wkernel.py``: ``w_kernel`` without the pattern
options, which the cells leave at their defaults).

Each plane: the far-field screen ``e^{2πi·w·(1 − √(1 − l² − m²))}`` on
``npix_ff``² points of the field of view, zero-padded to ``npix_ff·qpx``,
centred inverse FFT, the ``qpx``×``qpx`` oversampled taps × qpx².  Built in
float64 on the given device a few planes at a time, returned unconjugated.
"""

from __future__ import annotations

import math

import torch


def _ifft_centered(a: torch.Tensor) -> torch.Tensor:
    ax = (-2, -1)
    return torch.fft.fftshift(torch.fft.ifft2(torch.fft.ifftshift(a, dim=ax)),
                              dim=ax)


def w_kernels(theta: float, w, qpx: int, npix_ff: int, npix_kern: int,
              device=None) -> torch.Tensor:
    """``[nw, qpx, qpx, s, s]`` complex128 oversampled w-kernels for the
    plane centres ``w`` ``[nw]``."""
    f64 = torch.float64
    base = (torch.arange(npix_ff, dtype=f64, device=device)
            - npix_ff // 2) / npix_ff
    l = base[None, :].expand(npix_ff, npix_ff) * theta
    m = base[:, None].expand(npix_ff, npix_ff) * theta
    ph = 1.0 - torch.sqrt(1.0 - (l * l + m * m))
    w = torch.as_tensor(w, dtype=f64, device=device)
    angle = (2.0 * math.pi) * (w.reshape(-1, 1, 1) * ph)
    ff = torch.polar(torch.ones_like(angle), angle)
    na = npix_ff * qpx
    lo = na // 2 - npix_ff // 2
    pad = ff.new_zeros(ff.shape[:-2] + (na, na))
    pad[..., lo:lo + npix_ff, lo:lo + npix_ff] = ff
    af = _ifft_centered(pad)
    cons = na // 2 - qpx * (npix_kern // 2)
    f = torch.arange(qpx, device=device)
    y = torch.arange(npix_kern, device=device)
    rows = cons - f[:, None] + qpx * y[None, :]
    out = af[..., rows, :][..., rows]
    return out.movedim(-2, -3) * (qpx * qpx)


PLANES_AT_ONCE = 4    # a plane's padded screen is (npix_ff·qpx)² complex128


def w_bank(theta: float, centers, qpx: int, npix_ff: int, npix_kern: int,
           device=None) -> torch.Tensor:
    """The whole bank, :func:`w_kernels` :data:`PLANES_AT_ONCE` planes a
    call, as complex64 on ``device``."""
    centers = torch.as_tensor(centers, dtype=torch.float64)
    parts = [w_kernels(theta, centers[i:i + PLANES_AT_ONCE], qpx, npix_ff,
                       npix_kern, device=device).to(torch.complex64)
             for i in range(0, centers.shape[0], PLANES_AT_ONCE)]
    return torch.cat(parts)
