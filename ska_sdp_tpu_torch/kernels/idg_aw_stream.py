"""Streamed IDG(-AW) gridder: wrapper of the CUDA kernel
``csrc/idg_grid.cu`` and its plain PyTorch version (port of
``ska_sdp_tpu/kernels/idg_aw_stream_pallas.py``: ``_dft_factors``,
``idg_aw_grid_from_records_stream``, ``idg_aw_grid_stream`` and
``idg_aw_gridder_stream``).

Per run of sorted records (one antenna pair, one uv tile) the operator
accumulates ``a[q, r] = Σ_b v_b·e_y[q, b]·e_x[r, b]`` on the S×S subgrid
image, multiplies by the conjugated pair screen ``conj(A[ia1]·A[ia2])``,
applies the taper-folded DFT sandwich ``F·t·Fᵀ`` and adds the patch to the
padded grid at the run's origin ``(y0, x0)``.  With unit screens and zero
pair ids it is plain continuous-w IDG.

The wrapper launches the CUDA kernel for CUDA tensors and uses the plain
version only for CPU tensors; it never falls back.  Both compute in full
float32, the reference's ``exact`` precision tier.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import numpy as np
import torch

from ..ops.idg import _dft_matrix, kaiser_taper
from .idg_aw_records import STREAM_SUBGRIDS, idg_aw_run_records

_launches = 0


def launch_count() -> int:
    """Launches of the CUDA kernel since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _dft_factors(S: int, taper_beta: float, device=None):
    """The taper-folded DFT matrix ``F[y, q] = e^{−2πi k_y k_q / S}/S ·
    taper[q]`` (``k = i − S/2``) and its transpose, built in float64 and
    returned as contiguous complex64."""
    F = _dft_matrix(S, torch.complex128, device) / S
    if taper_beta > 0:
        F = F * kaiser_taper(S, taper_beta, torch.float64, device)[None, :]
    F = F.to(torch.complex64)
    return F, F.T.contiguous()


@contextlib.contextmanager
def _full_f32_matmul():
    """Pin float32 products to full precision (no TF32) for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def grid_from_records_plain(recs, starts, ends, y0, x0, ia1, ia2, screens,
                            *, grid_shape, theta: float, subgrid: int = 64,
                            taper_beta: float = 12.0):
    """Plain PyTorch version of the CUDA kernel: the padded complex64 grid
    ``[N + 2S, Nx + 2S]`` from run records, on the records' device.

    Records are processed in chunks: their rank-1 phase terms
    are summed into per-run accumulators with ``index_add_``; the pair
    screens and the sandwich then run as one batched product over the
    occupied runs, and the patches are added to the grid by flat index.
    """
    N, Nx = grid_shape
    S = subgrid
    HP, WP = N + 2 * S, Nx + 2 * S
    dev = recs.device
    f32 = torch.float32
    out = torch.zeros((HP, WP), dtype=torch.complex64, device=dev)
    active = torch.nonzero(ends > starts).squeeze(1)
    R = active.numel()
    if R == 0:
        return out
    st = starts[active].long()
    counts = ends[active].long() - st
    run_of = torch.repeat_interleave(torch.arange(R, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    rec = (torch.arange(run_of.numel(), device=dev) - first[run_of]
           + st[run_of])

    cq = torch.arange(S, dtype=f32, device=dev) - S // 2
    two_pi_s = torch.tensor(2.0 * math.pi / S, dtype=f32, device=dev)
    pi_ = torch.tensor(math.pi, dtype=f32, device=dev)
    ky = pi_ * (cq * (theta / S)) ** 2
    kx = pi_ * (cq * (theta * Nx / N / S)) ** 2
    cqs = two_pi_s * cq
    chunk = 8192 if dev.type == "cuda" else 1024     # bounds the temporaries
    acc = torch.zeros((R, S, S, 2), dtype=f32, device=dev)
    with _full_f32_matmul():
        for c0 in range(0, rec.numel(), chunk):
            idx = rec[c0:c0 + chunk]
            dy, dx, w, vr, vi = recs[:, idx]
            ph_y = cqs[None, :] * dy[:, None] - ky[None, :] * w[:, None]
            ph_x = cqs[None, :] * dx[:, None] - kx[None, :] * w[:, None]
            ey = torch.polar(torch.ones_like(ph_y), ph_y)
            ex = torch.polar(torch.ones_like(ph_x), ph_x)
            u = torch.complex(vr, vi)[:, None] * ey
            outer = u[:, :, None] * ex[:, None, :]
            acc.index_add_(0, run_of[c0:c0 + chunk],
                           torch.view_as_real(outer))

        nant = screens.shape[0]
        i1 = torch.clamp(ia1[active].long(), 0, nant - 1)
        i2 = torch.clamp(ia2[active].long(), 0, nant - 1)
        scr = screens.to(torch.complex64)
        t = torch.view_as_complex(acc) * torch.conj(scr[i1] * scr[i2])
        F, FT = _dft_factors(S, taper_beta, dev)
        patch = F @ t @ FT                                  # [R, S, S]

    ar = torch.arange(S, device=dev)
    rows = y0[active].long()[:, None] + ar
    cols = x0[active].long()[:, None] + ar
    flat = (rows[:, :, None] * WP + cols[:, None, :]).reshape(-1)
    torch.view_as_real(out).view(-1, 2).index_add_(
        0, flat, torch.view_as_real(patch).reshape(-1, 2))
    return out


def _check_cuda_inputs(recs, runs, screens, S: int):
    dev = recs.device
    if recs.dtype != torch.float32 or recs.dim() != 2 or recs.shape[0] != 5:
        raise ValueError(f"recs must be [5, n] float32, got "
                         f"{tuple(recs.shape)} {recs.dtype}")
    n_runs = runs[0].shape[0]
    for t in runs:
        if t.dtype != torch.int32 or t.shape != (n_runs,):
            raise ValueError("run tables must be int32 of one length")
    if screens.dtype != torch.complex64 or screens.dim() != 3 \
            or tuple(screens.shape[1:]) != (S, S):
        raise ValueError(f"screens must be [nant, {S}, {S}] complex64")
    for t in (recs, screens, *runs):
        if t.device != dev:
            raise ValueError("all kernel inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def _grid_from_records_cuda(recs, starts, ends, y0, x0, ia1, ia2, screens,
                            *, grid_shape, theta: float, subgrid: int,
                            taper_beta: float):
    """Launch ``csrc/idg_grid.cu`` on the current stream; returns the padded
    grid.  Raises on bad inputs and on a refused launch."""
    global _launches
    from ._build import load

    S = subgrid
    if S not in STREAM_SUBGRIDS:
        raise ValueError(f"subgrid {S} outside the kernel's envelope "
                         f"{STREAM_SUBGRIDS}")
    runs = (starts, ends, y0, x0, ia1, ia2)
    _check_cuda_inputs(recs, runs, screens, S)
    N, Nx = grid_shape
    HP, WP = N + 2 * S, Nx + 2 * S
    dev = recs.device
    out = torch.zeros((HP, WP), dtype=torch.complex64, device=dev)
    F, FT = _dft_factors(S, taper_beta, dev)
    lib = load("idg_grid")
    fn = lib.idg_grid_stream
    vp = ctypes.c_void_p
    fn.argtypes = [vp, ctypes.c_longlong, vp, vp, vp, vp, vp, vp,
                   ctypes.c_int, vp, ctypes.c_int, vp, vp, vp, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    lib.idg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.idg_cuda_error_string.restype = ctypes.c_char_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(recs.data_ptr(), recs.shape[1], starts.data_ptr(),
                ends.data_ptr(), y0.data_ptr(), x0.data_ptr(),
                ia1.data_ptr(), ia2.data_ptr(), starts.shape[0],
                screens.data_ptr(), screens.shape[0], F.data_ptr(),
                FT.data_ptr(), out.data_ptr(), WP, S,
                float(np.float32(2.0 * np.pi / S)), float(theta / S),
                float(theta * Nx / N / S), stream)
    if rc != 0:
        msg = lib.idg_cuda_error_string(rc).decode()
        raise RuntimeError(f"idg_grid_stream launch failed: {msg} ({rc})")
    _launches += 1
    return out


def idg_aw_grid_from_records_stream(recs, starts, ends, y0, x0, ia1, ia2,
                                    grid_shape, screens, *, theta: float,
                                    subgrid: int = 64,
                                    taper_beta: float = 12.0):
    """Streamed IDG(-AW) gridding of prepared run records; returns the
    ``[N, Nx]`` complex64 grid.

    CUDA tensors launch the CUDA kernel; CPU tensors take the plain
    version.  ``screens`` is ``[nant, S, S]`` complex64, unconjugated.
    """
    N, Nx = grid_shape
    S = subgrid
    kw = dict(grid_shape=grid_shape, theta=theta, subgrid=S,
              taper_beta=taper_beta)
    if recs.is_cuda:
        g = _grid_from_records_cuda(recs, starts, ends, y0, x0, ia1, ia2,
                                    screens, **kw)
    elif recs.device.type == "cpu":
        g = grid_from_records_plain(recs, starts, ends, y0, x0, ia1, ia2,
                                    screens, **kw)
    else:
        raise ValueError(f"no gridder for device {recs.device}")
    return g[S:S + N, S:S + Nx]


def idg_aw_gridder_stream(grid_shape, p, a1, a2, w, vis, screens, *,
                          theta: float, subgrid: int = 64, support: int = 15,
                          taper_beta: float = 12.0, max_runs: int = 4096,
                          fit_margin: int = 0, ordered: bool = False):
    """Streamed IDG(-AW) gridding end to end (prep + gridder) on complex
    visibilities; returns ``(guv [N, Nx] complex64, n_dropped)``."""
    recs, starts, ends, y0, x0, ia1, ia2, n_dropped, _ = idg_aw_run_records(
        grid_shape, p, a1, a2, w, vis.real, vis.imag, subgrid=subgrid,
        support=support, max_runs=max_runs, fit_margin=fit_margin,
        ordered=ordered, nant=screens.shape[0])
    guv = idg_aw_grid_from_records_stream(
        recs, starts, ends, y0, x0, ia1, ia2, grid_shape,
        screens.to(torch.complex64).contiguous(), theta=theta,
        subgrid=subgrid, taper_beta=taper_beta)
    return guv, n_dropped
