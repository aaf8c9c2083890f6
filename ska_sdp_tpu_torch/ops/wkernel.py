"""w-kernel synthesis: phase screen → oversampled gridding kernel (port of
``ska_sdp_tpu/ops/wkernel.py``).

  ``kernel_coordinates``  image-plane (l, m) grids, with the options'
                          pattern transform and shift
  ``w_kernel_function``   far-field screen e^{2πi·w·(1 − √(1 − l² − m²))}
  ``extract_oversampled`` the qpx×qpx oversampled taps, × qpx²
  ``tap_window``          the pruned transform's indices: the taps are
                          D·screen·Dᵀ·qpx²/N², D a 2-D DFT from the
                          screen's pixels to the qpx·s tap rows
  ``w_kernel_taps_plain`` that transform in PyTorch (the plain version of
                          ``csrc/wkernel_synth.cu``)
  ``w_kernel``            screen → taps: on the CPU zero-pad ×qpx →
                          centred iFFT → extract; on the card the pruned
                          transform (``kernels/wkernel_synth.py``)
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


def tap_window(npix_ff: int, qpx: int, npix_kern: int):
    """``(N, koff, joff)`` of the pruned transform that gives
    :func:`extract_oversampled`'s taps of the centred inverse FFT of a
    screen zero-padded to ``N = npix_ff·qpx``: tap ``(f, y)`` (row ``r =
    f·s + y``) sits at centred index ``k′ = koff − f + qpx·y`` and screen
    pixel ``j`` at ``j′ = j + joff``, so that

        taps = D·screen·Dᵀ·qpx²/N²,   D[r, j] = e^{2πi·k′·j′/N}.

    Both centres lie at ``N // 2`` (``fftshift``/``ifftshift``), for an odd
    N too.  Raises ``ValueError`` for taps outside the padded plane."""
    n = npix_ff * qpx
    lo = n // 2 - npix_ff // 2                 # pad_mid's leading zeros
    cons = n // 2 - qpx * (npix_kern // 2)     # extract_oversampled's origin
    if cons - (qpx - 1) < 0 or cons + qpx * (npix_kern - 1) >= n:
        raise ValueError(f"the taps of support {npix_kern} at qpx {qpx} "
                         f"fall outside the {n}² padded plane")
    return n, cons - n // 2, lo - n // 2


def w_kernel_taps_plain(ff: torch.Tensor, qpx: int, npix_kern: int,
                        conj: bool = False) -> torch.Tensor:
    """The taps ``[…, qpx, qpx, s, s]`` of screens ``ff`` ``[…, n0, n0]``
    as :func:`tap_window`'s ``D·ff·Dᵀ·qpx²/N²``, in ``ff``'s precision,
    conjugated where ``conj``: the phase index ``k′·j′ mod N`` in integers
    into a table of e^{2πi·q/N} made in float64 and rounded: the plain
    version of ``csrc/wkernel_synth.cu`` (which sums in another order), on
    any device."""
    n0 = ff.shape[-1]
    s = npix_kern
    n, koff, joff = tap_window(n0, qpx, s)
    dev = ff.device
    f = torch.arange(qpx, device=dev)
    y = torch.arange(s, device=dev)
    k = (koff - f[:, None] + qpx * y[None, :]).reshape(-1)       # r = f·s + y
    j = torch.arange(n0, device=dev) + joff
    table = torch.polar(torch.ones(n, dtype=torch.float64, device=dev),
                        (2.0 * math.pi / n) * torch.arange(
                            n, dtype=torch.float64, device=dev))
    d = table[torch.remainder(k[:, None] * j[None, :], n)].to(ff.dtype)
    taps = d @ ff @ d.transpose(0, 1) * (qpx * qpx / (n * n))
    lead = ff.shape[:-2]
    taps = taps.reshape(lead + (qpx, s, qpx, s)).movedim(-2, -3)
    return torch.conj(taps).resolve_conj() if conj else taps


def w_kernel(theta: float, w, opts: KernelOptions, dtype=torch.float64,
             device=None, conj: bool = False) -> torch.Tensor:
    """Oversampled w-kernel(s): ``[qpx, qpx, s, s]`` for a scalar ``w``,
    ``[nw, qpx, qpx, s, s]`` for a vector, complex of ``dtype``'s width,
    conjugated where ``conj``.

    The taps of the screen on an ``npix_ff``² far field zero-padded to
    ``npix_ff·qpx``, inverse-transformed (centred) and sampled at the
    oversampled tap positions.  On the CPU that route itself, which the
    benchmark's frozen bank (``benchmark/wbank.py``) equals bit for bit; on
    the card :func:`tap_window`'s pruned transform of the screens, one
    launch of ``csrc/wkernel_synth.cu``, with no fallback."""
    # imported here: the kernels package imports this module
    from ..kernels import wkernel_synth as synth

    l, m = kernel_coordinates(opts.npix_ff, theta, opts, dtype=dtype,
                              device=device)
    ff = w_kernel_function(l, m, w)
    if not ff.is_cuda:
        af = ifft_centered(pad_mid(ff, opts.npix_ff * opts.qpx))
        taps = extract_oversampled(af, opts.qpx, opts.npix_kern)
        return torch.conj(taps).resolve_conj() if conj else taps
    n0 = opts.npix_ff
    taps = synth.wkernel_synth(ff.reshape(-1, n0, n0), opts.qpx,
                               opts.npix_kern, conj=conj)
    return taps.reshape(ff.shape[:-2] + taps.shape[1:])


def w_kernel_bank(theta: float, w_centers, opts: KernelOptions,
                  dtype=torch.float64, device=None) -> torch.Tensor:
    """The conjugated bank ``[nw, qpx, qpx, s, s]`` for the bank gridder
    (the reference conjugates each plane when it builds the bank), built in
    span ``sdp.wkernel``; on the card the kernel conjugates as it writes."""
    with span("sdp.wkernel"):
        return w_kernel(theta, w_centers, opts, dtype=dtype, device=device,
                        conj=True)
