"""Gridder dispatch (port of the IDG part of ``ska_sdp_tpu/kernels/__init__.py``).

Plain IDG rides the streamed run gridder with unit screens and zero pair
ids: every record keys to (pair 0, uv tile), runs are the occupied tiles
and ``conj(1·1) = 1`` keeps the operator exact continuous-w IDG.

Dropped records are counted per gridder and reported once per gridder on
stderr.  The port has no slower route to fall back to: shapes outside the
streamed kernel's envelope raise ``NotImplementedError``.
"""

from __future__ import annotations

import sys

import torch

from ..ops.idg_aw import auto_fit_margin
from .idg_aw_records import STREAM_SUBGRIDS
from .idg_aw_stream import idg_aw_gridder_stream

_drop_counts: dict[str, int] = {}
_warned: set[str] = set()


def drop_counters() -> dict[str, int]:
    """Records dropped by each gridder since process start (or reset)."""
    return dict(_drop_counts)


def reset_drop_counters() -> None:
    _drop_counts.clear()
    _warned.clear()


def _note_drops(kind: str, n_dropped: int, reason: str) -> None:
    if n_dropped <= 0:
        return
    _drop_counts[kind] = _drop_counts.get(kind, 0) + n_dropped
    if kind not in _warned:
        _warned.add(kind)
        print(f"warning: {kind}: {n_dropped} in-bounds records dropped — "
              f"{reason}; counted in kernels.drop_counters()",
              file=sys.stderr)


def _idg_unit_run_bound(grid_shape, subgrid: int, support: int):
    """``max_runs`` for the unit-screen run path of plain IDG — the full
    tile count of the padded grid, so no record can overflow — or None
    when the streamed kernel cannot serve the shape losslessly.

    The margin must be at least 5: below it the tile split (side
    ``max(2·margin − 2, 8)``) could drop in-bounds records (S=32 with
    support 15 is such a case).  The grid lives in device memory, so no
    run-table cap applies."""
    if subgrid not in STREAM_SUBGRIDS:
        return None
    margin = auto_fit_margin(subgrid, support)
    if margin < 5:
        return None
    tc = 2 * margin - 2
    return ((max(grid_shape) + 2 * subgrid) // tc + 2) ** 2 + 64


def idg_gridder(grid_shape, p: torch.Tensor, w: torch.Tensor,
                vis: torch.Tensor, *, theta: float, subgrid: int = 64,
                support: int = 15, taper_beta: float = 12.0):
    """Image-domain gridding of ``vis`` at scaled baselines ``p`` ``[n, 3]``
    and ``w`` in wavelengths, on the inputs' device.

    Returns ``(guv [N, Nx] complex64, n_dropped)``; ``n_dropped`` (a 0-dim
    tensor) counts in-bounds records the run split could not place — zero
    by construction inside the envelope, since the run bound covers every
    tile.  The dirty image must be divided by the fine taper
    (``ops.idg.taper_fine``)."""
    if support > subgrid // 2 + 1:
        raise ValueError(
            f"IDG needs support <= subgrid/2+1; got s={support}, "
            f"S={subgrid} — use a larger subgrid")
    mr = _idg_unit_run_bound(grid_shape, subgrid, support)
    if mr is None:
        raise NotImplementedError(
            f"IDG at subgrid={subgrid}, support={support} is outside the "
            f"streamed gridder's envelope (S in {STREAM_SUBGRIDS}, fit "
            "margin >= 5); the fixed-tile IDG kernel that serves it "
            "(ska_sdp_tpu/kernels/idg_pallas.py) is not ported yet")
    zer = torch.zeros((p.shape[0],), dtype=torch.int32, device=p.device)
    scr = torch.ones((1, subgrid, subgrid), dtype=torch.complex64,
                     device=p.device)
    guv, n_dropped = idg_aw_gridder_stream(
        grid_shape, p, zer, zer, w, vis, scr, theta=theta, subgrid=subgrid,
        support=support, taper_beta=taper_beta, max_runs=mr)
    return guv, n_dropped
