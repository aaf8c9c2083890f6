"""Plain operations the reference's imaging and prediction share: units,
uniform weights, v ≥ 0 mirroring, Hermitian completion, centred FFTs, the
Kaiser taper and its fine-grid divisor, and the operand rounding of the
control."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

C = 299792458.0


def exact(x: torch.Tensor) -> torch.Tensor:
    """The reference's rounding: none."""
    return x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round a float32 or complex64 tensor's mantissas to TF32's 10 bits
    (nearest, ties to even): the control, float32 products on TF32
    operands."""
    if x.is_complex():
        return torch.view_as_complex(tf32(torch.view_as_real(
            x.resolve_conj())))
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def full_f32():
    """Matrix products in full float32 (TF32 off) for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def grid_size(cfg: dict) -> int:
    return int(round(cfg["theta"] * cfg["lam"]))


def wavelengths(req: dict, device) -> torch.Tensor:
    """``[n, 3]`` float32 uvw in wavelengths: the metres cast to float32,
    times ``f / c`` formed in float32."""
    uvw = torch.as_tensor(np.asarray(req["uvw"], np.float32), device=device)
    f = torch.tensor(req["freq"], dtype=torch.float32, device=device)
    return uvw * (f / C)


def uniform_weights(uvw_l: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``[n]`` float32 ``1 / (visibilities in the record's qpx=1 cell)``,
    cells ``floor(n/2 + u/lam·n + 0.5)``, flat ids below 0 wrapped once,
    ids out of range adding nothing and reading the nearest cell."""
    n, lam = grid_size(cfg), cfg["lam"]
    p = uvw_l / lam
    x = torch.floor(n // 2 + p[:, 0] * n + 0.5).to(torch.int64)
    y = torch.floor(n // 2 + p[:, 1] * n + 0.5).to(torch.int64)
    flat = y * n + x
    flat = torch.where(flat < 0, flat + n * n, flat)
    inb = (flat >= 0) & (flat < n * n)
    counts = torch.zeros((n * n,), dtype=torch.float32, device=p.device)
    counts.index_add_(0, flat.clamp(0, n * n - 1), inb.to(torch.float32))
    return 1.0 / counts[flat.clamp(0, n * n - 1)]


def mirrored(uvw_l: torch.Tensor, vis: torch.Tensor):
    """Baselines with v < 0 negated and their visibilities conjugated."""
    neg = uvw_l[:, 1] < 0
    return (torch.where(neg[:, None], -uvw_l, uvw_l),
            torch.where(neg, torch.conj(vis), vis))


def weighted_mirrored(req: dict, cfg: dict, device):
    """``(uvw_l mirrored, weighted mirrored complex64 visibilities)``."""
    uvw_l = wavelengths(req, device)
    vis = torch.as_tensor(np.asarray(req["vis"], np.complex64),
                          device=device)
    wt = uniform_weights(uvw_l, cfg)
    uvw_m, vis_m = mirrored(uvw_l, vis)
    return uvw_m, vis_m * wt.to(torch.complex64)


def hermitian(g: torch.Tensor) -> torch.Tensor:
    """``g + conj(mirror(g))``, the mirror through the off-centre zero
    point ``g[n − y, n − x]`` of an even grid (row and column 0 zero)."""
    n = g.shape[-1]
    m = torch.flip(g, dims=(-2, -1))
    if n % 2 == 0:
        m = torch.roll(m, shifts=(1, 1), dims=(-2, -1))
        m[..., 0, :] = 0
        m[..., :, 0] = 0
    return g + torch.conj(m)


def ifft2c(g: torch.Tensor) -> torch.Tensor:
    ax = (-2, -1)
    return torch.fft.fftshift(torch.fft.ifft2(torch.fft.ifftshift(g, dim=ax)),
                              dim=ax)


def fft2c(a: torch.Tensor) -> torch.Tensor:
    ax = (-2, -1)
    return torch.fft.fftshift(torch.fft.fft2(torch.fft.ifftshift(a, dim=ax)),
                              dim=ax)


def kaiser(S: int, beta: float, device=None) -> torch.Tensor:
    """float64 ``I0(β√(1 − (2(q − S/2)/S)²)) / I0(β)`` on S points."""
    q = (torch.arange(S, dtype=torch.float64, device=device) - S // 2) \
        / (S / 2)
    t = torch.special.i0(beta * torch.sqrt(torch.clamp(1 - q * q, 0, 1)))
    return t / torch.special.i0(torch.tensor(beta, dtype=torch.float64,
                                             device=device))


def fine_taper(N: int, S: int, beta: float, device=None) -> torch.Tensor:
    """float64 ``[N]``: the coarse taper (rounded to float32) zero-padded
    in its spectrum from S to N points and transformed back (centred),
    × N/S."""
    t = kaiser(S, beta, device).to(torch.float32).to(torch.complex128)
    spec = torch.fft.fftshift(torch.fft.fft(torch.fft.ifftshift(t)))
    pad = torch.zeros((N,), dtype=torch.complex128, device=device)
    pad[N // 2 - S // 2:N // 2 - S // 2 + S] = spec
    return torch.fft.fftshift(torch.fft.ifft(torch.fft.ifftshift(pad))
                              ).real * (N / S)


def dft_factor(S: int, beta: float, device=None) -> torch.Tensor:
    """complex64 ``F[y, q] = e^{−2πi·k_y·k_q/S}/S · t[q]``, ``k = i − S/2``,
    formed in float64."""
    k = torch.arange(S, dtype=torch.float64, device=device) - S // 2
    ph = -2.0 * math.pi * torch.outer(k, k) / S
    F = torch.polar(torch.ones_like(ph), ph) / S
    return (F * kaiser(S, beta, device)[None, :]).to(torch.complex64)
