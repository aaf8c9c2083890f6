"""Imaging functions and the PSF-normalised imaging pipeline (port of
``ska_sdp_tpu/models/imaging.py``).

  ``simple_imaging``           nearest-cell gridding
  ``conv_imaging``             one fixed oversampled kernel
  ``w_cache_imaging``          a w-binned kernel bank built on the fly
  ``wproj_imaging_from_bank``  a given bank, the plane closest to each w
  ``aw_imaging``               AW-projection (``aw_imaging_old`` is the
                               same function: the reference's two
                               schedulings give the same grid)
  ``do_imaging``               mirror → uniform weight → image and PSF grids
                               → Hermitian completion → centred iFFT → real
                               part → both divided by the PSF peak

Each imaging function has the reference's ``ImagingFunction`` signature
(θ, lam, uvw, src, vis) → uv-grid, with kernels and options bound in
front.  The kernel-based ones scatter through ``kernels.wproj_gridder``
(``csrc/wproj_grid.cu`` on the card), the AW one through
``kernels.aw_gridder``; the nearest-cell scatter is one ``index_add_``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import KernelOptions
from ..kernels import aw_gridder, wproj_gridder
from ..ops import doweight, ifft_centered, make_grid_hermitian, mirror_uvw
from ..ops.gridding import grid_nearest
from ..ops.search import find_closest
from ..ops.wkernel import w_kernel_bank
from ..utils.timing import add, readback, span

PSF_MODES = ("simple", "conv", "wcache")


def _empty_grid(theta: float, lam: int, dtype, device=None) -> torch.Tensor:
    n = int(round(theta * lam))
    return torch.zeros((n, n), dtype=dtype, device=device)


def simple_imaging(theta: float, lam: int, uvw: torch.Tensor, src,
                   vis: torch.Tensor) -> torch.Tensor:
    """Nearest-cell uv-grid ``[n, n]``, ``n = round(θ·lam)``."""
    guv = _empty_grid(theta, lam, vis.dtype, vis.device)
    return grid_nearest(guv, uvw / lam, vis)


def conv_imaging(kv: torch.Tensor, theta: float, lam: int,
                 uvw: torch.Tensor, src, vis: torch.Tensor,
                 chunk: int = 8192) -> torch.Tensor:
    """uv-grid through the one oversampled kernel ``kv`` ``[qpx, qpx, s,
    s]`` (applied as given): ``ops.gridding.convgrid``, which is the bank
    scatter on the one-plane bank ``kv[None]``."""
    n = int(round(theta * lam))
    wbin = torch.zeros((uvw.shape[0],), dtype=torch.int32, device=uvw.device)
    return wproj_gridder(kv[None], (n, n), uvw / lam, wbin, vis, chunk=chunk)


def w_cache_bins(uvw: torch.Tensor, wstep: float,
                 w_range: Optional[tuple] = None):
    """The w-cache's bins: ``(centres [steps] float64 numpy, wbin [n]
    int32 on uvw's device)``.  Each w rounds to a multiple of ``wstep`` in
    uvw's dtype (half to even); the bins span the rounded extent, read
    back to the host (one ``timing.readback``, between the two
    ``sdp.device_prep`` spans of the arithmetic), or ``w_range`` rounded
    the same way, into whose edge bins the w values outside it are clipped
    (no read of the data)."""
    with span("sdp.device_prep"):
        roundedw = wstep * torch.round(uvw[:, 2] / wstep)
    if w_range is None:
        minw, maxw = readback(torch.stack(torch.aminmax(roundedw)),
                              lambda t: t.tolist())
    else:
        minw = wstep * np.round(float(w_range[0]) / wstep)
        maxw = wstep * np.round(float(w_range[1]) / wstep)
    steps = int((maxw - minw) // wstep) + 1
    centers = minw + wstep * np.arange(steps, dtype=np.float64)
    with span("sdp.device_prep"):
        if w_range is not None:
            roundedw = torch.clamp(roundedw.to(torch.float64), minw, maxw)
        wbin = ((roundedw.to(torch.float64) - minw) // wstep).to(torch.int32)
    return centers, wbin


def w_cache_imaging(theta: float, lam: int, uvw: torch.Tensor, src,
                    vis: torch.Tensor, opts: KernelOptions = KernelOptions(),
                    chunk: int = 8192,
                    w_range: Optional[tuple] = None) -> torch.Tensor:
    """w-projection uv-grid with a bank built on the fly: w binned by
    ``opts.wstep`` (:func:`w_cache_bins`), one conjugated kernel per bin
    (``ops.wkernel.w_kernel_bank`` in the visibilities' real precision on
    their device, built anew on every call), and the bank scatter.  The
    open spans count the planes synthesised (``wkernel_planes``) and the
    bytes of the ``npix_ff``² screens they were transformed from
    (``wkernel_bytes``)."""
    real = vis.real.dtype
    centers, wbin = w_cache_bins(uvw, opts.wstep, w_range)
    with span("sdp.device_prep"):
        # the centres made on the card as the host makes them, in float64:
        # a copy from pageable memory would first wait for the card
        w = (centers[0] + opts.wstep * torch.arange(
            len(centers), dtype=torch.float64, device=vis.device)).to(real)
    bank = w_kernel_bank(theta, w, opts, dtype=real, device=vis.device)
    add("wkernel_planes", len(centers))
    add("wkernel_bytes", len(centers) * opts.npix_ff ** 2
        * bank.element_size())
    n = int(round(theta * lam))
    return wproj_gridder(bank, (n, n), uvw / lam, wbin, vis, chunk=chunk)


def wproj_imaging_from_bank(bank: torch.Tensor, wbin_centers: torch.Tensor,
                            theta: float, lam: int, uvw: torch.Tensor, src,
                            vis: torch.Tensor,
                            chunk: int = 8192) -> torch.Tensor:
    """w-projection uv-grid through a given conjugated bank ``[nw, qpx,
    qpx, s, s]`` with plane centres ``wbin_centers``, each visibility on
    the plane closest to its w."""
    wbin = find_closest(wbin_centers, uvw[:, 2])
    n = int(round(theta * lam))
    return wproj_gridder(bank, (n, n), uvw / lam, wbin, vis, chunk=chunk)


def aw_imaging(theta: float, lam: int, wkernels: torch.Tensor,
               wbin_centers: torch.Tensor, akernels: torch.Tensor,
               uvw: torch.Tensor, src, vis: torch.Tensor,
               chunk: int = 8192) -> torch.Tensor:
    """AW-projection uv-grid ``[n, n]``, ``n = round(θ·lam)``.

    ``wkernels`` ``[nw, qpx, qpx, s, s]`` is the unconjugated bank,
    ``wbin_centers`` ``[nw]`` its plane centres in wavelengths, ``akernels``
    ``[nant, s, s]`` the A-kernels; ``src`` starts with ``(a1, a2)``, each
    visibility's antennas (the reference passes ``(a1, a2, time, freq)``;
    only the antennas are read).  Each visibility takes the plane closest to
    its w."""
    with span("sdp.device_prep"):
        a1, a2 = src[0].to(torch.int32), src[1].to(torch.int32)
        guv = _empty_grid(theta, lam, vis.dtype, vis.device)
        wbin = find_closest(wbin_centers, uvw[:, 2])
        p = uvw / lam
    return aw_gridder(wkernels, akernels, guv, p, wbin, a1, a2, vis,
                      chunk=chunk)


aw_imaging_old = aw_imaging


def mode_imgfn(mode: str, theta: float, uvw: torch.Tensor,
               wstep: float = 2000.0, w_range: Optional[tuple] = None):
    """The reference CLI's imaging function of ``--mode simple``, ``conv``
    or ``wcache`` for uvw ``[n, 3]`` in wavelengths: ``conv`` binds the
    conjugated default-options kernel at the mean |w| (built on uvw's
    device in its precision), ``wcache`` the bin width ``wstep`` and the
    w range ``w_range`` (:func:`w_cache_bins`; None takes the data's
    extent), which the other modes refuse."""
    if w_range is not None and mode != "wcache":
        raise ValueError(f"w_range applies to mode 'wcache', not {mode!r}")
    if mode == "simple":
        return simple_imaging
    if mode == "wcache":
        return functools.partial(w_cache_imaging,
                                 opts=KernelOptions(wstep=wstep),
                                 w_range=w_range)
    if mode == "conv":
        w_mid = torch.abs(uvw[:, 2]).mean().reshape(1)
        kv = w_kernel_bank(theta, w_mid, KernelOptions(), dtype=uvw.dtype,
                           device=uvw.device)[0]
        return functools.partial(conv_imaging, kv)
    raise ValueError(f"no imaging function for mode {mode!r}; do_imaging's "
                     f"modes are {PSF_MODES}")


class ImagingResult(NamedTuple):
    image: torch.Tensor    # [n, n] real dirty image ÷ pmax
    psf: torch.Tensor      # [n, n] real point-spread function ÷ pmax
    pmax: torch.Tensor     # 0-dim PSF peak


def do_imaging(theta: float, lam: int, uvw: torch.Tensor, a1, a2, t,
               f: float, vis: torch.Tensor, imgfn) -> ImagingResult:
    """The reference's full imaging pipeline on ``uvw``'s device: mirror into
    v ≥ 0, uniform weights of the mirrored uvw, the image grid of the
    weighted visibilities and the PSF grid of the weights through
    ``imgfn``, Hermitian completion, centred inverse FFT and real part of
    each, both divided by the PSF peak.  ``uvw`` ``[n, 3]`` is in
    wavelengths; ``src = (a1, a2, t, f)`` goes to ``imgfn`` unmirrored.
    The mirror and the weights run in span ``sdp.device_prep``, each
    grid's completion and transform (and the PSF's, the division by the
    peak) in span ``sdp.finish``."""
    with span("sdp.device_prep"):
        n = vis.shape[0]
        src = (a1, a2, t, torch.full((n,), f, dtype=uvw.dtype,
                                     device=uvw.device))
        uvw1, vis1 = mirror_uvw(uvw, vis)
        wt = doweight(theta, lam, uvw1, torch.ones_like(vis))
        wvis = wt * vis1

    cdrt = imgfn(theta, lam, uvw1, src, wvis)
    with span("sdp.finish"):
        drt = ifft_centered(make_grid_hermitian(cdrt)).real
    cpsf = imgfn(theta, lam, uvw1, src, wt)
    with span("sdp.finish"):
        psf = ifft_centered(make_grid_hermitian(cpsf)).real
        pmax = torch.max(psf)
        return ImagingResult(image=drt / pmax, psf=psf / pmax, pmax=pmax)
