"""Fixed-tile IDG gridder and degridder: the record prep and the wrappers
that run it on the streamed kernels (port of
``ska_sdp_tpu/kernels/idg_pallas.py``: ``idg_bin_records``,
``idg_bin_records_multi``, ``idg_records_for_channel``,
``idg_grid_from_records``, ``idg_gridder_pallas``; and of
``ska_sdp_tpu/kernels/idg_degrid_pallas.py``: ``_prep_with_order`` and
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
window's origin.  Degridding is the adjoint: per occupied subgrid the
window W becomes ``a = F′ᴴ·W·conj(F′)`` and each record reads
``v = Σ_q conj(e_y[q])·Σ_r a[q, r]·conj(e_x[r])``.  That is the streamed
IDG(-AW) operator of ``kernels/idg_aw_stream.py`` with unit screens and
pair 0, so the fixed-tile records run on it: :func:`tile_runs` makes each
subgrid one run, at the window's origin moved from the T-padded layout to
the streamed one's S-padded layout (``(gy·T + T, gx·T + T)``),
and the streamed kernels (``csrc/idg_grid.cu``, ``csrc/idg_degrid.cu``)
or, for CPU tensors, their plain versions do the rest.  The degridder's
window sandwiches run inside the kernel, per run, from the ``[N, Nx]``
model grid.

Records: the gridder's are ``[5, n]`` float32 rows ``(dy, dx, w, vis_re,
vis_im)`` sorted by subgrid id, with ``starts`` ``[n_sub + 1]`` int32 (the
excluded records sort last, past ``starts[-1]``); the degridder's are
``[3, n]`` rows ``(dy, dx, w)`` with ``order`` (the original index of each
sorted record) and ``valid``.  The reference's ``[nblk, 8, 256]`` TPU
packing is not kept.

The wrappers launch the streamed CUDA kernels for CUDA tensors and use
the plain versions only for CPU tensors; they never fall back.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..utils.timing import launch_counters, launched, readback, span
from . import idg_aw_stream as stream

GRID_KERNEL = "idg_tile_grid"        # counts of the fixed-tile route's
DEGRID_KERNEL = "idg_tile_degrid"    # launches of the streamed kernels
MAX_SUBGRID = stream.MAX_SUBGRID
# launches of the streamed CUDA gridder or degridder by this route since
# the last reset, and the reset; the streamed module's counts rise with them
launch_count, reset_launch_count = launch_counters(GRID_KERNEL,
                                                   DEGRID_KERNEL)


class TileGeometry(NamedTuple):
    S: int        # subgrid side
    T: int        # stride, and the padding margin on each side
    nty: int      # subgrid rows
    ntx: int      # subgrid columns

    @property
    def n_sub(self) -> int:
        return self.nty * self.ntx


def tile_geometry(grid_shape, subgrid: int) -> TileGeometry:
    """The subgrid tiling of an ``[N, Nx]`` grid.  Raises ``ValueError`` for
    an odd subgrid (the tiling needs S = 2T) and ``NotImplementedError``
    above :data:`MAX_SUBGRID`."""
    S = int(subgrid)
    if S < 2 or S % 2:
        raise ValueError(f"the fixed-tile IDG needs an even subgrid, got {S}")
    if S > MAX_SUBGRID:
        raise NotImplementedError(
            f"subgrid {S} exceeds the streamed kernels' largest instance, "
            f"{MAX_SUBGRID}")
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


def idg_bin_records_multi(grid_shape, p, w, vis_re_mc, vis_im_mc, *,
                          subgrid: int = 64, support: int = 15):
    """Multi-channel binning: bin once at the reference channel, update each
    channel elementwise (:func:`idg_records_for_channel`).

    ``p``/``w`` are at the reference channel, ``vis_re_mc``/``vis_im_mc``
    ``[nch, n]``.  Unlike :func:`idg_bin_records` the stride assignment is
    centred: a record's support anchor sits at offset ``[c0, c0 + T)`` in
    its window, ``c0 = (S − s)//2 − T//2``, so a channel's drift has slack
    toward both window edges.  One sort orders the geometry and every
    channel's visibilities together.

    Returns ``(base [6, n] float32 rows (dy, dx, w, cy, cx, live), vis_s
    [nch, 2, n] float32, starts [n_sub + 1] int32)``: ``cy``/``cx`` are the
    subgrid centre's offset from the grid centre, ``live`` the records on
    the grid; excluded records sort past ``starts[-1]``."""
    geo = tile_geometry(grid_shape, subgrid)
    if support > geo.T + 1:
        raise ValueError(f"IDG needs support <= subgrid/2+1; got "
                         f"s={support}, S={geo.S}")
    N, Nx = grid_shape
    S, T, s = geo.S, geo.T, support
    i32, f32 = torch.int32, torch.float32
    yc = torch.floor(N // 2 + p[:, 1] * N + 0.5).to(i32)
    xc = torch.floor(Nx // 2 + p[:, 0] * Nx + 0.5).to(i32)
    y0 = yc - s // 2
    x0 = xc - s // 2
    valid = (y0 > -s) & (y0 < N) & (x0 > -s) & (x0 < Nx)
    zero = torch.zeros((), dtype=i32, device=p.device)
    c0 = (S - s) // 2 - T // 2
    gy = torch.clamp(torch.div(torch.where(valid, y0 + T, zero) - c0, T,
                               rounding_mode="floor"), 0, geo.nty - 1)
    gx = torch.clamp(torch.div(torch.where(valid, x0 + T, zero) - c0, T,
                               rounding_mode="floor"), 0, geo.ntx - 1)
    t = torch.where(valid, gy * geo.ntx + gx,
                    torch.full_like(gy, geo.n_sub))
    posy = (N // 2 + p[:, 1] * float(N) + T).to(f32)
    posx = (Nx // 2 + p[:, 0] * float(Nx) + T).to(f32)
    ctry = (gy * T + S // 2).to(f32)
    ctrx = (gx * T + S // 2).to(f32)
    base = torch.stack([posy - ctry, posx - ctrx, w.to(f32),
                        ctry - float(N // 2 + T), ctrx - float(Nx // 2 + T),
                        valid.to(f32)])
    vis = torch.where(valid, torch.stack([vis_re_mc, vis_im_mc], 1).to(f32),
                      torch.zeros((), dtype=f32, device=p.device))
    perm, starts = _sort_csr(t, geo.n_sub)
    return (base[:, perm].contiguous(), vis[:, :, perm].contiguous(),
            starts)


def idg_records_for_channel(base, vis_c, ratio, *, subgrid: int = 64,
                            support: int = 15):
    """One channel's gridder records from :func:`idg_bin_records_multi`
    (elementwise, no sort): ``dy_c = r·dy + (r − 1)·cy`` (and ``dx_c``),
    ``w_c = r·w`` in float32, ``r = f_c/f_ref`` rounded to float32.  A record
    whose support the channel's drift pushes out of its window
    (``floor(d + S/2 + 0.5) − s//2 ∉ [0, S − s]``) loses its visibilities, and
    the live ones among them are counted.

    ``vis_c`` is the channel's ``[2, n]`` slice.  Returns ``(recs [5, n]
    float32 for idg_grid_from_records, n_masked (0-dim int64))``."""
    S, s = subgrid, support
    r = torch.as_tensor(ratio, dtype=torch.float32, device=base.device)
    dy, dx, w, cy, cx, live = base
    dy_c = r * dy + (r - 1.0) * cy
    dx_c = r * dx + (r - 1.0) * cx
    lo = s // 2 - S / 2 - 0.5
    hi = S / 2 - s + s // 2 + 0.5
    ok = (dy_c >= lo) & (dy_c < hi) & (dx_c >= lo) & (dx_c < hi)
    okf = ok.to(torch.float32) * live
    n_masked = torch.sum((live > 0) & ~ok)
    recs = torch.stack([dy_c, dx_c, r * w, vis_c[0] * okf, vis_c[1] * okf])
    return recs, n_masked


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


class TileRuns(NamedTuple):
    """The run table of the subgrids (:func:`tile_runs`)."""
    starts_ext: torch.Tensor   # [R + 1] int32: run r is [ext[r], ext[r + 1])
    y0: torch.Tensor           # [R] int32 origins in the S-padded grid
    x0: torch.Tensor
    pair: torch.Tensor         # [R] int32 zeros: pair 0, the unit screen


@functools.lru_cache(maxsize=16)
def _origin_table(grid_shape, subgrid: int, device):
    """Per subgrid id: its window's origin ``(gy·T + T, gx·T + T)`` in the
    streamed kernels' S-padded grid ``[N + 2S, Nx + 2S]`` (``[2, n_sub]``
    int32), whether that origin lies outside ``[0, N + S] × [0, Nx + S]``,
    where the kernel's S×S patch would leave the grid (``[n_sub]`` bool),
    ``[n_sub]`` int32 zeros and the ``[1, S, S]`` unit screen; built once
    per (shape, S, device) and only read."""
    geo = tile_geometry(grid_shape, subgrid)
    N, Nx = grid_shape
    S, T = geo.S, geo.T
    t = torch.arange(geo.n_sub, dtype=torch.int32, device=device)
    gy = torch.div(t, geo.ntx, rounding_mode="floor")
    org = torch.stack([gy * T + T, (t - gy * geo.ntx) * T + T])
    bad = (org[0] > N + S) | (org[1] > Nx + S)
    return (org.contiguous(), bad, torch.zeros_like(t),
            torch.ones((1, S, S), dtype=torch.complex64, device=device))


def _table(starts, grid_shape, subgrid: int) -> TileRuns:
    """:func:`tile_runs`' table without its check: views of ``starts`` and
    of the cached origin table, no device work."""
    geo = tile_geometry(grid_shape, subgrid)
    if tuple(starts.shape) != (geo.n_sub + 1,):
        raise ValueError(f"starts must be [{geo.n_sub + 1}], got "
                         f"{tuple(starts.shape)}")
    org, _, zeros, _ = _origin_table(tuple(grid_shape), geo.S, starts.device)
    return TileRuns(starts, org[0], org[1], zeros)


def _check_origins(starts, grid_shape, subgrid: int) -> None:
    """:func:`tile_runs`' check: one flag read back from the device."""
    bad = _origin_table(tuple(grid_shape), int(subgrid), starts.device)[1]
    if readback(torch.any((starts[1:] > starts[:-1]) & bad), bool):
        raise ValueError("an occupied subgrid's origin lies outside the "
                         "padded grid: these are not the fixed-tile prep's "
                         "records for this grid")


def tile_runs(starts, grid_shape, subgrid: int) -> TileRuns:
    """The fixed-tile records as the streamed kernels' run table: subgrid
    ``t`` is run ``t``, its records ``[starts[t], starts[t + 1])``, its
    origin ``(gy·T + T, gx·T + T)`` (the window's, moved from the T-padded
    layout to the S-padded one; S = 2T) and pair 0.  ``starts`` is the
    table's ``starts_ext`` as it stands; records past ``starts[-1]``
    belong to no run.  The empty subgrids stay in the table: they cost the
    kernels a read or an idle block each, less than compacting the table
    to the occupied ones costs a call (a ``nonzero`` and its host sync).
    The same table serves both devices.

    Raises ``ValueError`` if an occupied subgrid's origin lies outside
    ``[0, N + S]`` (rows) or ``[0, Nx + S]`` (columns), where its S×S patch
    would leave the S-padded grid.  Both preps keep inside by construction
    (the multi prep's centred window included).  On the card the wrappers
    check after their launch, where the read-back waits behind the kernel
    instead of holding its launch back: the gridder kernel skips such a run
    and flags it, the degridder's wrapper runs this check."""
    runs = _table(starts, grid_shape, subgrid)
    _check_origins(starts, grid_shape, subgrid)
    return runs


def _unit_screen(grid_shape, subgrid: int, device):
    return _origin_table(tuple(grid_shape), int(subgrid), device)[3]


def idg_grid_from_records(recs, starts, grid_shape, *, theta: float,
                          subgrid: int = 64, taper_beta: float = 12.0):
    """IDG gridding of a binned record stream (:func:`idg_bin_records`);
    returns the ``[N, Nx]`` complex64 grid (the reference returns its real
    and imaginary planes; the port keeps one complex grid, as its other
    gridders do).  The subgrids run on the streamed gridder
    (:func:`tile_runs`): CUDA tensors launch ``csrc/idg_grid.cu``, CPU
    tensors take its plain version.  Raises as :func:`tile_runs` does, on
    the card after the launch."""
    r = _table(starts, grid_shape, subgrid)
    args = (recs, r.starts_ext[:-1], r.starts_ext[1:], r.y0, r.x0, r.pair,
            r.pair, _unit_screen(grid_shape, subgrid, recs.device))
    kw = dict(grid_shape=grid_shape, theta=theta, subgrid=subgrid,
              taper_beta=taper_beta)
    if recs.is_cuda:
        # the kernel counts the runs it skips for leaving the grid: the
        # check reads that flag back, after the launch
        with span("sdp.kernel.idg_grid"):
            gp, outside = stream._grid_from_records_cuda(*args, **kw)
        launched(GRID_KERNEL)
        if readback(outside, bool):
            _check_origins(starts, grid_shape, subgrid)
    elif recs.device.type == "cpu":
        _check_origins(starts, grid_shape, subgrid)
        with span("sdp.kernel.idg_grid"):
            gp = stream.grid_from_records_plain(*args, **kw)
    else:
        raise ValueError(f"no gridder for device {recs.device}")
    N, Nx = grid_shape
    S = subgrid
    return gp[S:S + N, S:S + Nx]


def idg_degrid_from_records(recs, starts, order, grid, *, theta: float,
                            subgrid: int = 64, taper_beta: float = 12.0):
    """IDG degridding of the ``[N, Nx]`` model grid at the records of
    :func:`prep_with_order`; returns ``[n]`` complex64 visibilities in the
    records' original order, 0 for excluded records.  The subgrids run on
    the streamed degridder (:func:`tile_runs`), which reads each window of
    the model grid itself (zero outside it): CUDA tensors launch
    ``csrc/idg_degrid.cu``, CPU tensors take its plain version.  Raises
    as :func:`tile_runs` does, on the card after the launch."""
    shape = tuple(grid.shape)
    r = _table(starts, shape, subgrid)
    if not recs.is_cuda:
        _check_origins(starts, shape, subgrid)
    v = stream.idg_aw_degrid_from_records_stream(
        recs, r.starts_ext, r.y0, r.x0, r.pair, r.pair, order, grid,
        _unit_screen(shape, subgrid, recs.device), theta=theta,
        subgrid=subgrid, taper_beta=taper_beta)
    if recs.is_cuda:
        launched(DEGRID_KERNEL)
        _check_origins(starts, shape, subgrid)
    return v


def idg_gridder_tile(grid_shape, p, w, vis, *, theta: float,
                     subgrid: int = 64, support: int = 15,
                     taper_beta: float = 12.0):
    """Fixed-tile IDG gridding end to end (prep + gridder) of complex
    visibilities; returns the ``[N, Nx]`` complex64 grid.  Nothing in
    bounds is dropped.  The dirty image must be divided by the fine taper
    (``ops.idg.taper_fine``)."""
    with span("sdp.device_prep"):
        recs, starts = idg_bin_records(grid_shape, p, w, vis.real,
                                       vis.imag, subgrid=subgrid,
                                       support=support)
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
    with span("sdp.device_prep"):
        recs, starts, order, _ = prep_with_order(grid_shape, p, w,
                                                 subgrid=subgrid,
                                                 support=support)
    return idg_degrid_from_records(recs, starts, order, grid, theta=theta,
                                   subgrid=subgrid, taper_beta=taper_beta)
