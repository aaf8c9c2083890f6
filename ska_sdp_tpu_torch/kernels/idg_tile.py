"""Fixed-tile IDG gridder and degridder: the record prep, wrappers of the
CUDA kernels ``csrc/idg_tile_grid.cu`` and ``csrc/idg_tile_degrid.cu`` and
their plain PyTorch versions (port of ``ska_sdp_tpu/kernels/idg_pallas.py``:
``idg_bin_records``, ``idg_grid_from_records``, ``idg_gridder_pallas``; and
of ``ska_sdp_tpu/kernels/idg_degrid_pallas.py``: ``_prep_with_order`` and
``idg_degrid_wproj_pallas``).

Geometry: subgrids of side S (even) at stride T = S/2 tile the padded grid
``[(nty + 1)·T, (ntx + 1)·T]``, which holds the ``[N, Nx]`` grid at offset
T.  A record whose support anchor ``y0 = round(pos) − s//2`` lies in stride
cell ``(gy, gx) = (y0p // T, x0p // T)`` belongs to subgrid ``gy·ntx + gx``,
whose window starts at ``(gy·T, gx·T)``; with support ``s ≤ T + 1`` the
footprint always fits, so no in-bounds record is dropped.  Records whose
anchor lies off the grid are excluded: they grid nothing and predict 0.

Gridding: per subgrid ``a[q, r] = Σ_b v_b·e_y[q, b]·e_x[r, b]`` with
``e(ph) = e^{i·ph}``, ``ph = 2π/S·c_q·d − π·(c_q·θ/S)²·w``, ``c_q = q − S/2``,
and the patch ``F′·a·F′ᵀ`` (``F′ = F·diag(taper)/S``) is added at the
window's origin.  The plain version emits the reference's per-subgrid
patches and folds them with ``ops.idg._fold_overlap``; the kernel adds each
patch with atomics.  Degridding is the adjoint: per occupied subgrid the
window W becomes ``a = F′ᴴ·W·conj(F′)`` (the reference's ``/S²`` is the
``1/S`` of each factor), a batched matmul outside the kernel as the
reference leaves it to XLA, and each record reads
``v = Σ_q conj(e_y[q])·Σ_r a[q, r]·conj(e_x[r])``.

Records: the gridder's are ``[5, n]`` float32 rows ``(dy, dx, w, vis_re,
vis_im)`` sorted by subgrid id, with ``starts`` ``[n_sub + 1]`` int32 (the
excluded records sort last, past ``starts[-1]``); the degridder's are
``[3, n]`` rows ``(dy, dx, w)`` with ``order`` (the original index of each
sorted record) and ``valid``.  The reference's ``[nblk, 8, 256]`` TPU
packing is not kept (:func:`from_jax_tile_records` converts it).

The wrappers launch the CUDA kernels for CUDA tensors and use the plain
versions only for CPU tensors; they never fall back.  All compute in full
float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.idg import _fold_overlap, _overlap_windows
from ._build import bind
from .idg_aw_stream import (_dft_factors, _full_f32_matmul, _phase_factors,
                            _phase_scalars)

GRID_KERNEL = "idg_tile_grid"
DEGRID_KERNEL = "idg_tile_degrid"
MAX_SUBGRID = 128        # the kernels hold one S×S subgrid in shared memory
_launches = {GRID_KERNEL: 0, DEGRID_KERNEL: 0}


def launch_count(kernel: str = GRID_KERNEL) -> int:
    """Launches of a CUDA kernel (:data:`GRID_KERNEL` or
    :data:`DEGRID_KERNEL`) since the last reset."""
    return _launches[kernel]


def reset_launch_count() -> None:
    """Set every kernel's launch count to 0."""
    for k in _launches:
        _launches[k] = 0


class TileGeometry(NamedTuple):
    S: int        # subgrid side
    T: int        # stride, and the padding margin on each side
    nty: int      # subgrid rows
    ntx: int      # subgrid columns

    @property
    def n_sub(self) -> int:
        return self.nty * self.ntx

    @property
    def padded_shape(self):
        return ((self.nty + 1) * self.T, (self.ntx + 1) * self.T)


def tile_geometry(grid_shape, subgrid: int) -> TileGeometry:
    """The subgrid tiling of an ``[N, Nx]`` grid.  Raises ``ValueError`` for
    an odd subgrid (the fold needs S = 2T) and ``NotImplementedError`` above
    :data:`MAX_SUBGRID`."""
    S = int(subgrid)
    if S < 2 or S % 2:
        raise ValueError(f"the fixed-tile IDG needs an even subgrid, got {S}")
    if S > MAX_SUBGRID:
        raise NotImplementedError(
            f"subgrid {S} exceeds the fixed-tile kernels' {MAX_SUBGRID}: "
            "they hold one subgrid in shared memory")
    T = S // 2
    N, Nx = grid_shape
    return TileGeometry(S, T, -(-(N + 2 * T) // T) + 1,
                        -(-(Nx + 2 * T) // T) + 1)


def _tile_keys(grid_shape, p, support: int, geo: TileGeometry):
    """Each record's subgrid id (``n_sub`` when excluded), its float32
    position relative to that subgrid's centre, and ``valid``.  Positions
    are taken in ``p``'s dtype and cast afterwards, as the reference does,
    so the ids agree with it at cell boundaries."""
    if support > geo.T + 1:
        raise ValueError(f"IDG needs support <= subgrid/2+1; got "
                         f"s={support}, S={geo.S}")
    N, Nx = grid_shape
    S, T, s = geo.S, geo.T, support
    i32 = torch.int32
    yc = torch.floor(N // 2 + p[:, 1] * N + 0.5).to(i32)
    xc = torch.floor(Nx // 2 + p[:, 0] * Nx + 0.5).to(i32)
    y0 = yc - s // 2
    x0 = xc - s // 2
    valid = (y0 > -s) & (y0 < N) & (x0 > -s) & (x0 < Nx)
    zero = torch.zeros((), dtype=i32, device=p.device)
    gy = torch.where(valid, y0 + T, zero) // T
    gx = torch.where(valid, x0 + T, zero) // T
    t = torch.where(valid, gy * geo.ntx + gx,
                    torch.full_like(gy, geo.n_sub))
    dy = (N // 2 + p[:, 1] * float(N) + T) - (gy * T + S // 2).to(p.dtype)
    dx = (Nx // 2 + p[:, 0] * float(Nx) + T) - (gx * T + S // 2).to(p.dtype)
    return t, dy.to(torch.float32), dx.to(torch.float32), valid


def _sort_csr(t, n_sub: int):
    """Stable sort by subgrid id: ``(perm, starts [n_sub + 1] int32)``."""
    t_s, perm = torch.sort(t, stable=True)
    q = torch.arange(n_sub + 1, dtype=t_s.dtype, device=t.device)
    return perm, torch.searchsorted(t_s, q).to(torch.int32)


def idg_bin_records(grid_shape, p, w, vis_re, vis_im, *, subgrid: int = 64,
                    support: int = 15):
    """Bin and sort visibilities into the gridder's record stream.

    ``p`` ``[n, 3]`` scaled baselines, ``w`` ``[n]`` in wavelengths,
    ``vis_re``/``vis_im`` ``[n]``, all on one device.  Returns ``(recs [5,
    n] float32, starts [n_sub + 1] int32)``; excluded records carry zero
    visibilities and sort past ``starts[-1]``."""
    geo = tile_geometry(grid_shape, subgrid)
    t, dy, dx, valid = _tile_keys(grid_shape, p, support, geo)
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=p.device)
    vr = torch.where(valid, vis_re.to(f32), zero)
    vi = torch.where(valid, vis_im.to(f32), zero)
    perm, starts = _sort_csr(t, geo.n_sub)
    recs = torch.stack([dy, dx, w.to(f32), vr, vi])[:, perm].contiguous()
    return recs, starts


def prep_with_order(grid_shape, p, w, *, subgrid: int = 64,
                    support: int = 15):
    """Bin and sort records for the degridder, carrying each record's
    original index (the degrid twin of :func:`idg_bin_records`).  Returns
    ``(recs [3, n] float32 rows dy/dx/w in sorted order, starts [n_sub +
    1] int32, order [n] int32, valid [n] bool in original order)``."""
    geo = tile_geometry(grid_shape, subgrid)
    t, dy, dx, valid = _tile_keys(grid_shape, p, support, geo)
    perm, starts = _sort_csr(t, geo.n_sub)
    recs = torch.stack([dy, dx, w.to(torch.float32)])[:, perm].contiguous()
    return recs, starts, perm.to(torch.int32), valid


def from_jax_tile_records(recs, starts, order=None, valid=None,
                          device=None):
    """The port's records from the reference prep's numpy outputs.

    ``recs`` is the reference's ``[nblk, 8, 256]`` blocks layout (or ``[8,
    n_pad]`` rows).  Without ``order``: the gridder's ``(recs [5, n_pad],
    starts)`` of ``idg_bin_records``; the padding records lie past
    ``starts[-1]``, in no subgrid.  With ``order`` and ``valid`` (from
    ``_prep_with_order``): the degridder's ``(recs [3, n], starts, order,
    valid)``, cut to the ``n`` records."""
    r = np.asarray(recs, np.float32)
    if r.ndim == 3:
        r = r.transpose(1, 0, 2).reshape(8, -1)
    st = torch.as_tensor(np.array(starts, np.int32), device=device)
    if order is None:
        return torch.as_tensor(np.array(r[:5]), device=device), st
    od = np.array(order, np.int32)
    return (torch.as_tensor(np.array(r[:3, :od.shape[0]]), device=device),
            st, torch.as_tensor(od, device=device),
            torch.as_tensor(np.array(valid, bool), device=device))


def _members(starts, occ):
    """For the occupied subgrids ``occ``: the index into ``occ`` of every
    record in ``[0, starts[-1])`` (records are sorted by subgrid)."""
    counts = (starts[1:] - starts[:-1]).long()[occ.long()]
    return torch.repeat_interleave(
        torch.arange(occ.numel(), device=starts.device), counts)


def _occupied(starts):
    return torch.nonzero(starts[1:] > starts[:-1]).squeeze(1)


def grid_from_records_plain(recs, starts, *, grid_shape, theta: float,
                            subgrid: int = 64, taper_beta: float = 12.0):
    """Plain PyTorch version of the CUDA gridder, with its arguments: the
    padded complex64 grid ``[(nty + 1)·T, (ntx + 1)·T]`` on the records'
    device.

    Records are taken in chunks and their rank-1 phase terms summed into
    per-subgrid accumulators with ``index_add_``; the DFT sandwich runs as
    one batched product over the occupied subgrids, and the reference's
    per-subgrid patches are folded with ``_fold_overlap``."""
    geo = tile_geometry(grid_shape, subgrid)
    N, Nx = grid_shape
    S = geo.S
    dev = recs.device
    patches = torch.zeros((geo.n_sub, S, S), dtype=torch.complex64,
                          device=dev)
    occ = _occupied(starts)
    if occ.numel():
        slot = _members(starts, occ)
        phases = _phase_factors(S, theta, theta * Nx / N, dev)
        chunk = (2**25 if dev.type == "cuda" else 2**21) // (S * S)
        acc = torch.zeros((occ.numel(), S, S, 2), dtype=torch.float32,
                          device=dev)
        with _full_f32_matmul():
            for c0 in range(0, slot.numel(), chunk):
                hi = min(c0 + chunk, slot.numel())
                dy, dx, w, vr, vi = recs[:, c0:hi]
                ey, ex = phases(dy, dx, w)
                u = torch.complex(vr, vi)[:, None] * ey
                acc.index_add_(0, slot[c0:hi], torch.view_as_real(
                    u[:, :, None] * ex[:, None, :]))
            F, FT = _dft_factors(S, taper_beta, dev)
            patches[occ] = F @ torch.view_as_complex(acc) @ FT
    return _fold_overlap(patches.reshape(geo.nty, geo.ntx, S, S), geo.nty,
                         geo.ntx, S, geo.T)


def tile_images(grid, starts, *, subgrid: int = 64,
                taper_beta: float = 12.0):
    """The degridder's prologue: the occupied subgrids' images ``a =
    F′ᴴ·W·conj(F′)`` ``[R, S, S]`` complex64 from their windows W of the
    padded model grid (``_overlap_windows``), and the subgrid ids ``occ``
    ``[R]`` int32.  A batched matmul in full float32 (no TF32), outside the
    kernel as in the reference; empty subgrids are skipped."""
    N, Nx = grid.shape
    geo = tile_geometry((N, Nx), subgrid)
    S, T = geo.S, geo.T
    dev = grid.device
    gp = torch.zeros(geo.padded_shape, dtype=torch.complex64, device=dev)
    gp[T:T + N, T:T + Nx] = grid
    occ = _occupied(starts)
    wins = _overlap_windows(gp, geo.nty, S, T, geo.ntx).reshape(
        geo.n_sub, S, S)[occ]
    F, _ = _dft_factors(S, taper_beta, dev)
    with _full_f32_matmul():
        a_sub = F.conj().T @ wins @ F.conj()
    return a_sub.contiguous(), occ.to(torch.int32)


def degrid_from_records_plain(recs, starts, order, occ, a_sub, *,
                              grid_shape, theta: float, subgrid: int = 64):
    """Plain PyTorch version of the CUDA degridder, with its arguments:
    ``[n]`` complex64 visibilities in original order from the occupied
    subgrids' images ``a_sub`` (:func:`tile_images`), on the records'
    device.  Records past ``starts[-1]`` (excluded) predict exactly 0."""
    N, Nx = grid_shape
    S = int(subgrid)
    dev = recs.device
    out = torch.zeros((order.shape[0],), dtype=torch.complex64, device=dev)
    if occ.numel() == 0:
        return out
    slot = _members(starts, occ)
    phases = _phase_factors(S, theta, theta * Nx / N, dev)
    chunk = (2**25 if dev.type == "cuda" else 2**22) // (S * S)
    with _full_f32_matmul():
        for c0 in range(0, slot.numel(), chunk):
            hi = min(c0 + chunk, slot.numel())
            ey, ex = phases(*recs[:3, c0:hi])
            t = torch.einsum("bqr,br->bq", a_sub[slot[c0:hi]], ex.conj())
            out[order[c0:hi].long()] = torch.sum(ey.conj() * t, dim=1)
    return out


def _check_cuda_records(recs, starts, rows: int, n_sub: int, *others):
    if recs.dtype != torch.float32 or recs.dim() != 2 \
            or recs.shape[0] != rows:
        raise ValueError(f"recs must be [{rows}, n] float32, got "
                         f"{tuple(recs.shape)} {recs.dtype}")
    if starts.dtype != torch.int32 or tuple(starts.shape) != (n_sub + 1,):
        raise ValueError(f"starts must be [{n_sub + 1}] int32, got "
                         f"{tuple(starts.shape)} {starts.dtype}")
    for t in (recs, starts, *others):
        if t.device != recs.device:
            raise ValueError("all kernel inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def _padded_side(S: int) -> int:
    """The kernels' register tiling: S rounded up to a multiple of 16."""
    return -(-S // 16) * 16


@functools.lru_cache(maxsize=16)
def _padded_dft(S: int, taper_beta: float, device):
    """The gridder's taper-folded DFT factor and its transpose, zero-padded
    to the kernel's tiling; built once per (S, β, device) and only read."""
    SP = _padded_side(S)
    F = torch.zeros((SP, SP), dtype=torch.complex64, device=device)
    F[:S, :S] = _dft_factors(S, taper_beta, device)[0]
    return F, F.T.contiguous()


def _grid_from_records_cuda(recs, starts, *, grid_shape, theta: float,
                            subgrid: int, taper_beta: float):
    """Launch ``csrc/idg_tile_grid.cu`` on the current stream; returns the
    padded grid.  Raises on bad inputs and on a refused launch."""
    geo = tile_geometry(grid_shape, subgrid)
    _check_cuda_records(recs, starts, 5, geo.n_sub)
    N, Nx = grid_shape
    S, dev = geo.S, recs.device
    HP, WP = geo.padded_shape
    out = torch.zeros((HP, WP), dtype=torch.complex64, device=dev)
    F, FT = _padded_dft(S, float(taper_beta), dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn, err = bind("idg_tile_grid", "idg_tile_grid",
                   [vp, ctypes.c_longlong, vp, ci, ci, vp, vp, vp, ci, ci,
                    ci, cf, cf, cf, vp])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(recs.data_ptr(), recs.shape[1], starts.data_ptr(),
                geo.n_sub, geo.ntx, F.data_ptr(), FT.data_ptr(),
                out.data_ptr(), WP, S, geo.T,
                *_phase_scalars(S, theta, N, Nx), stream)
    if rc != 0:
        raise RuntimeError(f"{GRID_KERNEL} launch failed: "
                           f"{err(rc).decode()} ({rc})")
    _launches[GRID_KERNEL] += 1
    return out


def _degrid_from_records_cuda(recs, starts, order, occ, a_sub, *,
                              grid_shape, theta: float, subgrid: int):
    """Launch ``csrc/idg_tile_degrid.cu`` on the current stream; returns the
    visibilities in original order.  Raises on bad inputs and on a refused
    launch."""
    geo = tile_geometry(grid_shape, subgrid)
    S = geo.S
    _check_cuda_records(recs, starts, 3, geo.n_sub, order, occ, a_sub)
    n = recs.shape[1]
    if order.dtype != torch.int32 or tuple(order.shape) != (n,):
        raise ValueError(f"order must be [{n}] int32")
    R = occ.shape[0]
    if occ.dtype != torch.int32 or occ.dim() != 1:
        raise ValueError("occ must be a 1-D int32 tensor")
    if a_sub.dtype != torch.complex64 or tuple(a_sub.shape) != (R, S, S):
        raise ValueError(f"a_sub must be [{R}, {S}, {S}] complex64")
    N, Nx = grid_shape
    dev = recs.device
    out = torch.zeros((n,), dtype=torch.complex64, device=dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn, err = bind("idg_tile_degrid", "idg_tile_degrid",
                   [vp, ctypes.c_longlong, vp, vp, ci, vp, vp, ci, cf, cf,
                    cf, vp, vp])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(recs.data_ptr(), n, starts.data_ptr(), occ.data_ptr(), R,
                a_sub.data_ptr(), order.data_ptr(), S,
                *_phase_scalars(S, theta, N, Nx), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{DEGRID_KERNEL} launch failed: "
                           f"{err(rc).decode()} ({rc})")
    _launches[DEGRID_KERNEL] += 1
    return out


def idg_grid_from_records(recs, starts, grid_shape, *, theta: float,
                          subgrid: int = 64, taper_beta: float = 12.0):
    """IDG gridding of a binned record stream (:func:`idg_bin_records`);
    returns the ``[N, Nx]`` complex64 grid (the reference returns its real
    and imaginary planes; the port keeps one complex grid, as its other
    gridders do).  CUDA tensors launch the CUDA kernel; CPU tensors take
    the plain version."""
    geo = tile_geometry(grid_shape, subgrid)
    kw = dict(grid_shape=grid_shape, theta=theta, subgrid=subgrid,
              taper_beta=taper_beta)
    if recs.is_cuda:
        gp = _grid_from_records_cuda(recs, starts, **kw)
    elif recs.device.type == "cpu":
        gp = grid_from_records_plain(recs, starts, **kw)
    else:
        raise ValueError(f"no gridder for device {recs.device}")
    N, Nx = grid_shape
    return gp[geo.T:geo.T + N, geo.T:geo.T + Nx]


def idg_degrid_from_records(recs, starts, order, grid, *, theta: float,
                            subgrid: int = 64, taper_beta: float = 12.0):
    """IDG degridding of the ``[N, Nx]`` model grid at the records of
    :func:`prep_with_order`; returns ``[n]`` complex64 visibilities in the
    records' original order, 0 for excluded records.  The prologue
    (:func:`tile_images`) runs on either device; CUDA tensors then launch
    the CUDA kernel, CPU tensors take the plain version."""
    a_sub, occ = tile_images(grid, starts, subgrid=subgrid,
                             taper_beta=taper_beta)
    kw = dict(grid_shape=tuple(grid.shape), theta=theta, subgrid=subgrid)
    if recs.is_cuda:
        return _degrid_from_records_cuda(recs, starts, order, occ, a_sub,
                                         **kw)
    if recs.device.type == "cpu":
        return degrid_from_records_plain(recs, starts, order, occ, a_sub,
                                         **kw)
    raise ValueError(f"no degridder for device {recs.device}")


def idg_gridder_tile(grid_shape, p, w, vis, *, theta: float,
                     subgrid: int = 64, support: int = 15,
                     taper_beta: float = 12.0):
    """Fixed-tile IDG gridding end to end (prep + gridder) of complex
    visibilities; returns the ``[N, Nx]`` complex64 grid.  Nothing in
    bounds is dropped.  The dirty image must be divided by the fine taper
    (``ops.idg.taper_fine``)."""
    recs, starts = idg_bin_records(grid_shape, p, w, vis.real, vis.imag,
                                   subgrid=subgrid, support=support)
    return idg_grid_from_records(recs, starts, grid_shape, theta=theta,
                                 subgrid=subgrid, taper_beta=taper_beta)


def idg_degrid_tile(grid_shape, p, w, grid, *, theta: float,
                    subgrid: int = 64, support: int = 15,
                    taper_beta: float = 12.0):
    """Fixed-tile IDG degridding end to end (prep + degridder) of the
    ``[N, Nx]`` grid; returns ``[n]`` complex64 visibilities, 0 for records
    whose support anchor lies off the grid."""
    if tuple(grid.shape) != tuple(grid_shape):
        raise ValueError(f"grid {tuple(grid.shape)} does not match "
                         f"grid_shape {tuple(grid_shape)}")
    recs, starts, order, _ = prep_with_order(grid_shape, p, w,
                                             subgrid=subgrid, support=support)
    return idg_degrid_from_records(recs, starts, order, grid, theta=theta,
                                   subgrid=subgrid, taper_beta=taper_beta)
