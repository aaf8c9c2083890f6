"""IDG(-AW) run prep: sort records into (pair, uv-tile) runs and build the
run table (port of the prep half of ``ska_sdp_tpu/kernels/idg_aw_pallas.py``:
``idg_aw_run_records``, ``_run_csr``, ``idg_aw_run_records_multi`` and
``idg_aw_records_for_channel``, and of
``ska_sdp_tpu/kernels/idg_aw_degrid_pallas.py::idg_aw_degrid_records``).

Plain tensor work on the records' device: one stable sort (a fused
single int32 key when ``nant`` allows it, as the reference does) and a
``searchsorted`` inversion of the monotone run ids.  The integer outputs
(``starts``, ``ends``, ``y0``, ``x0``, ``ia1``, ``ia2``, ``n_dropped``) are
the reference's exactly.

Gridder records are held as ``[5, n]`` float32 rows ``(dy, dx, w,
vis_re, vis_im)`` in sorted order, degridder records as ``[3, n]`` rows
``(dy, dx, w)`` with the sort permutation beside them; the reference's
padded ``[8, n_pad]`` TPU layout is not kept.
"""

from __future__ import annotations

import torch

from ..ops.idg_aw import PAIR_SHIFT, SENTINEL, _record_keys, auto_fit_margin

# Subgrid sizes at which plain IDG takes this run prep rather than the
# fixed-tile prep, the reference's route and drop accounting; IDG-AW takes
# this prep at every even S the kernels take.
STREAM_SUBGRIDS = (32, 64, 128)


def _run_csr(pk_s, tk_s, n: int, max_runs: int, Tc: int, ntx_t: int,
             S: int, HP: int, WP: int):
    """Run boundaries → run table (CSR) and per-run scalars from the sorted
    key streams (runs are contiguous in sorted order).

    Returns ``(starts_ext [max_runs + 1], starts, ends, y0, x0, ia1, ia2
    [max_runs], overflow [n])``, all int32 except the bool ``overflow``.
    """
    i32 = torch.int32
    new_run = torch.ones((n,), dtype=i32, device=pk_s.device)
    new_run[1:] = ((pk_s[1:] != pk_s[:-1])
                   | (tk_s[1:] != tk_s[:-1])).to(i32)
    run_id = torch.cumsum(new_run, 0, dtype=i32) - 1
    overflow = run_id >= max_runs
    # run_id is sorted, so the CSR is its inversion: the first record of
    # run q is the count of records with run_id < q
    q = torch.arange(max_runs + 1, dtype=i32, device=pk_s.device)
    starts_ext = torch.searchsorted(run_id, q).to(i32)
    starts = starts_ext[:max_runs]
    ends = torch.clamp(starts_ext[1:], max=n)

    f = torch.clamp(starts, max=n - 1).long()
    tk_run = tk_s[f]
    ty_r = tk_run // ntx_t
    tx_r = tk_run - ty_r * ntx_t
    y0 = torch.clamp(ty_r * Tc - (S - Tc) // 2, 0, HP - S)
    x0 = torch.clamp(tx_r * Tc - (S - Tc) // 2, 0, WP - S)
    pk_run = pk_s[f]
    ia1 = pk_run // PAIR_SHIFT
    ia2 = pk_run - ia1 * PAIR_SHIFT
    return starts_ext, starts, ends, y0, x0, ia1, ia2, overflow


def idg_aw_run_records(grid_shape, p, a1, a2, w, vis_re, vis_im, *,
                       subgrid: int = 64, support: int = 15,
                       max_runs: int = 4096, fit_margin: int = 0,
                       ordered: bool = False, nant: int = 0):
    """Sort records into (pair, uv-tile) runs for the streamed gridder.

    ``p`` ``[n, 3]`` float32 scaled baselines, ``a1``/``a2`` ``[n]``
    antenna (or screen-slot) ids, ``w`` ``[n]`` in wavelengths,
    ``vis_re``/``vis_im`` ``[n]`` float32, all on one device.

    ``ordered=True`` skips the sort: each maximal contiguous same-key
    segment becomes its own run, so a pair-major stream needs no sort and
    a poorly ordered one overflows ``max_runs`` (counted in
    ``n_dropped``).  ``nant > 0`` enables the fused single-key sort when
    ``nant²·ntile < 2³⁰``; pair ids at or past ``nant`` are then clamped,
    exactly like the gridder's screen-row clamp.  Either sort gives the
    same permutation.

    Returns ``(recs [5, n] float32, starts, ends, y0, x0, ia1, ia2
    [max_runs] int32, n_dropped (0-dim int64), (HP, WP))``.
    """
    n = p.shape[0]
    if n == 0:
        raise ValueError("idg_aw_run_records needs at least one record")
    (pkey, tkey, dy, dx, valid, fit, Tc, ntx_t,
     HP, WP) = _record_keys(grid_shape, p, a1, a2, subgrid, support,
                            fit_margin)
    S = subgrid
    f32, i32 = torch.float32, torch.int32
    use = valid & fit
    zero = torch.zeros((), dtype=f32, device=p.device)
    vr = torch.where(use, vis_re.to(f32), zero)
    vi = torch.where(use, vis_im.to(f32), zero)
    rows = torch.stack([dy, dx, w.to(f32), vr, vi])

    ntile = (((HP - 1) // Tc) + 1) * ntx_t
    fused_ok = nant > 0 and nant * nant * ntile < SENTINEL
    if ordered:
        pk_s, tk_s, recs = pkey, tkey, rows
    elif fused_ok:
        c1 = torch.clamp(a1.to(i32), max=nant - 1)
        c2 = torch.clamp(a2.to(i32), max=nant - 1)
        fused = torch.where(use, (c1 * nant + c2) * ntile + tkey,
                            torch.full_like(tkey, SENTINEL))
        fused_s, perm = torch.sort(fused, stable=True)
        recs = rows[:, perm]
        # decode the (pair, tile) streams the CSR reads; sentinel records
        # decode to a meaningless tile, but their visibilities are zero
        pid_s = fused_s // ntile
        i1_s = pid_s // nant
        i2_s = pid_s - i1_s * nant
        pk_s = torch.where(fused_s >= SENTINEL,
                           torch.full_like(fused_s, SENTINEL),
                           i1_s * PAIR_SHIFT + i2_s)
        tk_s = fused_s - pid_s * ntile
    else:
        # lexicographic (pair, tile) order as one int64 key
        key = pkey.to(torch.int64) * 2**31 + tkey.to(torch.int64)
        _, perm = torch.sort(key, stable=True)
        recs = rows[:, perm]
        pk_s, tk_s = pkey[perm], tkey[perm]

    _, starts, ends, y0, x0, ia1, ia2, overflow = _run_csr(
        pk_s, tk_s, n, max_runs, Tc, ntx_t, S, HP, WP)
    # disjoint: unfit records carry the sentinel, so the overflow term
    # (placeable records only) never counts them twice
    placeable_s = pk_s < SENTINEL
    n_dropped = (torch.sum(valid & ~fit)
                 + torch.sum(overflow & placeable_s))
    return (recs.contiguous(), starts, ends, y0, x0, ia1, ia2, n_dropped,
            (HP, WP))


def idg_aw_run_records_multi(grid_shape, p, a1, a2, w, vis_re_mc,
                             vis_im_mc, *, subgrid: int = 64,
                             support: int = 15, max_runs: int = 4096,
                             fit_margin: int = 0, drift_cells: int = 0,
                             ordered: bool = False):
    """Multi-channel run prep: bin once at the reference channel, update
    each channel elementwise (:func:`idg_aw_records_for_channel`).

    ``p``/``w`` are at the reference channel (a channel group's centre
    frequency), ``vis_re_mc``/``vis_im_mc`` ``[nch, n]``.  The binning margin
    is the full fit margin less ``drift_cells``, so a record binned at the
    reference channel stays within the full margin at every channel that
    moves it by at most that many cells.  One stable two-key (pair, tile)
    sort orders the geometry and every channel's visibilities together;
    ``ordered=True`` skips it, as in :func:`idg_aw_run_records`.

    Returns ``(base [6, n] float32 rows (dy, dx, w, cy, cx, live), vis_s
    [nch, 2, n] float32, starts, ends, y0, x0, ia1, ia2 [max_runs] int32,
    n_dropped_base (0-dim int64), (HP, WP))``: ``cy``/``cx`` are the
    record's tile-centre offset from the grid centre and ``live`` marks the
    records inside a run.
    """
    S = subgrid
    margin_full = fit_margin if fit_margin > 0 else auto_fit_margin(S,
                                                                     support)
    margin_bin = margin_full - drift_cells
    if margin_bin <= 0:
        raise ValueError("drift_cells leaves no binning margin")
    n = p.shape[0]
    if n == 0:
        raise ValueError("idg_aw_run_records_multi needs at least one record")
    (pkey, tkey, dy, dx, valid, fit, Tc, ntx_t,
     HP, WP) = _record_keys(grid_shape, p, a1, a2, S, support, margin_bin)
    N, Nx = grid_shape
    f32 = torch.float32
    use = valid & fit
    ty = tkey // ntx_t
    tx = tkey - ty * ntx_t
    y0r = torch.clamp(ty * Tc - (S - Tc) // 2, 0, HP - S)
    x0r = torch.clamp(tx * Tc - (S - Tc) // 2, 0, WP - S)
    cy = (y0r + (S // 2 - N // 2 - S)).to(f32)
    cx = (x0r + (S // 2 - Nx // 2 - S)).to(f32)
    geo = torch.stack([dy, dx, w.to(f32), cy, cx])
    vis = torch.where(use, torch.stack([vis_re_mc, vis_im_mc], 1).to(f32),
                      torch.zeros((), dtype=f32, device=p.device))
    if ordered:
        pk_s, tk_s = pkey, tkey
    else:
        key = pkey.to(torch.int64) * 2**31 + tkey.to(torch.int64)
        _, perm = torch.sort(key, stable=True)
        pk_s, tk_s = pkey[perm], tkey[perm]
        geo, vis = geo[:, perm], vis[:, :, perm]

    _, starts, ends, y0, x0, ia1, ia2, overflow = _run_csr(
        pk_s, tk_s, n, max_runs, Tc, ntx_t, S, HP, WP)
    placeable_s = pk_s < SENTINEL
    n_dropped = (torch.sum(valid & ~fit)
                 + torch.sum(overflow & placeable_s))
    live = (placeable_s & ~overflow).to(f32)
    base = torch.cat([geo, live[None]])
    return (base, vis.contiguous(), starts, ends, y0, x0, ia1, ia2,
            n_dropped, (HP, WP))


def idg_aw_records_for_channel(base, vis_c, ratio, *, subgrid: int = 64,
                               support: int = 15, fit_margin: int = 0):
    """One channel's gridder records from the multi prep (elementwise, no
    sort): ``dy_c = r·dy + (r − 1)·cy`` (and ``dx_c``), ``w_c = r·w`` in
    float32 with ``r = f_c/f_ref`` rounded to float32, the reference's
    order of operations.  Records outside the full fit margin at this
    channel keep their place but lose their visibilities, and the live ones
    among them are counted.

    ``vis_c`` is the channel's ``[2, n]`` slice of ``vis_s``.  Returns
    ``(recs [5, n] float32 for idg_aw_grid_from_records_stream, n_masked
    (0-dim int64))``."""
    margin_full = fit_margin if fit_margin > 0 else auto_fit_margin(subgrid,
                                                                     support)
    r = torch.as_tensor(ratio, dtype=torch.float32, device=base.device)
    dy, dx, w, cy, cx, live = base
    dy_c = r * dy + (r - 1.0) * cy
    dx_c = r * dx + (r - 1.0) * cx
    ok = (torch.abs(dy_c) <= margin_full) & (torch.abs(dx_c) <= margin_full)
    okf = ok.to(torch.float32)
    n_masked = torch.sum((live > 0) & ~ok)
    recs = torch.stack([dy_c, dx_c, r * w, vis_c[0] * okf, vis_c[1] * okf])
    return recs, n_masked


def idg_aw_degrid_records(grid_shape, p, a1, a2, w, *, subgrid: int = 64,
                          support: int = 15, max_runs: int = 4096,
                          fit_margin: int = 0):
    """Sort records into (pair, uv-tile) runs for the streamed degridder,
    carrying each record's original index (the degrid twin of
    :func:`idg_aw_run_records`).

    The sort is the reference's two-key stable sort, as one int64 key: the
    fused int32 key would order the sentinel records differently, and
    ``order_s`` must match the reference exactly.

    Returns ``(recs [3, n] float32 rows dy/dx/w in sorted order,
    starts_ext [max_runs + 1], y0, x0, ia1, ia2 [max_runs] int32, order_s
    [n] int32 original index of each sorted record, use [n] bool
    original-order output mask, n_dropped (0-dim int64))``.  Runs are
    ``[starts_ext[r], min(starts_ext[r + 1], n))``.
    """
    n = p.shape[0]
    if n == 0:
        raise ValueError("idg_aw_degrid_records needs at least one record")
    (pkey, tkey, dy, dx, valid, fit, Tc, ntx_t,
     HP, WP) = _record_keys(grid_shape, p, a1, a2, subgrid, support,
                            fit_margin)
    key = pkey.to(torch.int64) * 2**31 + tkey.to(torch.int64)
    _, perm = torch.sort(key, stable=True)
    pk_s, tk_s = pkey[perm], tkey[perm]
    recs = torch.stack([dy, dx, w.to(torch.float32)])[:, perm].contiguous()
    starts_ext, _, _, y0, x0, ia1, ia2, overflow = _run_csr(
        pk_s, tk_s, n, max_runs, Tc, ntx_t, subgrid, HP, WP)
    n_dropped = (torch.sum(valid & ~fit)
                 + torch.sum(overflow & (pk_s < SENTINEL)))
    return (recs, starts_ext, y0, x0, ia1, ia2, perm.to(torch.int32),
            valid & fit, n_dropped)
