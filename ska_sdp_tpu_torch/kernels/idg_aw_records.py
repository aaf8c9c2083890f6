"""IDG(-AW) run prep: sort records into (pair, uv-tile) runs and build the
run table (port of the prep half of ``ska_sdp_tpu/kernels/idg_aw_pallas.py``:
``idg_aw_run_records`` and ``_run_csr``).

Plain tensor work on the records' device: one stable sort (a fused
single int32 key when ``nant`` allows it, as the reference does) and a
``searchsorted`` inversion of the monotone run ids.  The integer outputs
(``starts``, ``ends``, ``y0``, ``x0``, ``ia1``, ``ia2``, ``n_dropped``) are
the reference's exactly.

Records are held as ``[5, n]`` float32 rows ``(dy, dx, w, vis_re,
vis_im)`` in sorted order; the reference's padded ``[8, n_pad]`` TPU
layout is not kept.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.idg_aw import PAIR_SHIFT, SENTINEL, _record_keys

# Subgrid sizes the streamed gridder takes.
STREAM_SUBGRIDS = (32, 64, 128)


def _run_csr(pk_s, tk_s, n: int, max_runs: int, Tc: int, ntx_t: int,
             S: int, HP: int, WP: int):
    """Run boundaries → run table (CSR) and per-run scalars from the sorted
    key streams (runs are contiguous in sorted order).

    Returns ``(starts, ends, y0, x0, ia1, ia2 [max_runs], overflow [n])``,
    all int32 except the bool ``overflow``.
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
    return starts, ends, y0, x0, ia1, ia2, overflow


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

    starts, ends, y0, x0, ia1, ia2, overflow = _run_csr(
        pk_s, tk_s, n, max_runs, Tc, ntx_t, S, HP, WP)
    # disjoint: unfit records carry the sentinel, so the overflow term
    # (placeable records only) never counts them twice
    placeable_s = pk_s < SENTINEL
    n_dropped = (torch.sum(valid & ~fit)
                 + torch.sum(overflow & placeable_s))
    return (recs.contiguous(), starts, ends, y0, x0, ia1, ia2, n_dropped,
            (HP, WP))


def from_jax_run_records(recs, starts, ends, y0, x0, ia1, ia2, n_dropped,
                         device=None):
    """The port's run records from the reference prep's numpy outputs.

    ``recs`` is the reference's ``[8, n_pad]`` rows layout or its
    ``[nblk, 8, C]`` blocks layout; the three zero rows are dropped and the
    padding records (zero visibilities, outside every run) are kept.
    Returns the first eight entries of :func:`idg_aw_run_records`.
    """
    r = np.asarray(recs, np.float32)
    if r.ndim == 3:
        r = r.transpose(1, 0, 2).reshape(8, -1)
    rows = torch.as_tensor(np.array(r[:5]), device=device)

    def i32(a):
        return torch.as_tensor(np.array(a, np.int32), device=device)

    return (rows, i32(starts), i32(ends), i32(y0), i32(x0), i32(ia1),
            i32(ia2), torch.as_tensor(int(np.asarray(n_dropped)),
                                      device=device))
