"""Gridder and degridder dispatch (port of the bank w-projection, fused
AW, IDG and IDG-AW parts of ``ska_sdp_tpu/kernels/__init__.py``).

The bank w-projection pair ``wproj_gridder`` / ``wproj_degridder`` lives in
``kernels/wproj.py``: one CUDA kernel each serves every support and grid
size, so unlike the reference there is no fallback route to count.  The
fused AW gridder ``aw_gridder`` (``kernels/aw_fused.py``) rides one CUDA
kernel for every grid and table size: the reference's VMEM gates, its
tiled kernel and its slab route (``slab``, ``config.aw_slab``) have no
counterpart.

Plain IDG rides the streamed run kernels with unit screens and zero pair
ids where they serve the shape losslessly: every record keys to (pair 0, uv
tile), runs are the occupied tiles and ``conj(1·1) = 1`` keeps the operator
exact continuous-w IDG.  Every other shape (S outside
``STREAM_SUBGRIDS``, or a fit margin below 5, as S=32 with support 15 has)
takes the fixed-tile prep (``kernels/idg_tile.py``), as the reference
does: any even S up to 128 with support ≤ S/2 + 1, no record limit, and no
in-bounds record dropped; its occupied subgrids then run on the same
streamed kernels.  IDG-AW rides the streamed kernels with per-antenna
screens at any even S up to 128 whose taper fit margin is positive (S ≥ 28
with support 15): the run prep has no subgrid set of its own, so the
reference's XLA realization of the other subgrids
(``ska_sdp_tpu/ops/idg_aw.py::idg_grid_aw`` / ``idg_degrid_aw``) is the
same operator on the same (pair, uv-tile) runs and needs no second route.

Dropped records are counted per gridder and reported once per gridder on
stderr.
"""

from __future__ import annotations

import sys

import torch

from ..ops.idg_aw import auto_fit_margin
from ..utils.timing import COUNTERS
from .idg_aw_records import STREAM_SUBGRIDS
from .aw_fused import aw_gridder
from .idg_aw_stream import (check_subgrid, idg_aw_degridder_stream,
                            idg_aw_gridder_stream)
from .idg_tile import idg_degrid_tile, idg_gridder_tile
from .wproj import wproj_degridder, wproj_gridder

__all__ = [
    "aw_gridder",
    "drop_counters",
    "idg_aw_degridder",
    "idg_aw_gridder",
    "idg_degridder",
    "idg_gridder",
    "reset_drop_counters",
    "wproj_degridder",
    "wproj_gridder",
]

_warned: set[str] = set()


def drop_counters() -> dict[str, int]:
    """Records dropped by each gridder since process start (or reset)."""
    return COUNTERS.group("dropped/")


def reset_drop_counters() -> None:
    COUNTERS.reset("dropped/")
    _warned.clear()


def note_drops(kind: str, n_dropped: int, reason: str) -> None:
    """Count ``n_dropped`` under ``dropped/<kind>`` and warn once per
    gridder."""
    if n_dropped <= 0:
        return
    COUNTERS.add(f"dropped/{kind}", n_dropped)
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


def _check_idg_support(subgrid: int, support: int) -> None:
    if support > subgrid // 2 + 1:
        raise ValueError(
            f"IDG needs support <= subgrid/2+1; got s={support}, "
            f"S={subgrid} — use a larger subgrid")


def idg_gridder(grid_shape, p: torch.Tensor, w: torch.Tensor,
                vis: torch.Tensor, *, theta: float, subgrid: int = 64,
                support: int = 15, taper_beta: float = 12.0):
    """Image-domain gridding of ``vis`` at scaled baselines ``p`` ``[n, 3]``
    and ``w`` in wavelengths, on the inputs' device.

    Returns ``(guv [N, Nx] complex64, n_dropped)``; ``n_dropped`` (a 0-dim
    tensor) counts in-bounds records that could not be placed — zero by
    construction on both routes: the streamed run bound covers every tile
    and the fixed-tile route places every record.  The dirty image must be
    divided by the fine taper (``ops.idg.taper_fine``)."""
    _check_idg_support(subgrid, support)
    mr = _idg_unit_run_bound(grid_shape, subgrid, support)
    if mr is None:
        guv = idg_gridder_tile(grid_shape, p, w, vis, theta=theta,
                               subgrid=subgrid, support=support,
                               taper_beta=taper_beta)
        return guv, torch.zeros((), dtype=torch.int64, device=p.device)
    zer = torch.zeros((p.shape[0],), dtype=torch.int32, device=p.device)
    scr = torch.ones((1, subgrid, subgrid), dtype=torch.complex64,
                     device=p.device)
    guv, n_dropped = idg_aw_gridder_stream(
        grid_shape, p, zer, zer, w, vis, scr, theta=theta, subgrid=subgrid,
        support=support, taper_beta=taper_beta, max_runs=mr)
    return guv, n_dropped


def idg_degridder(grid_shape, p: torch.Tensor, w: torch.Tensor,
                  grid: torch.Tensor, *, theta: float, subgrid: int = 64,
                  support: int = 15, taper_beta: float = 12.0):
    """Image-domain degridding (exact continuous-w predict) of the
    ``[N, Nx]`` grid at scaled baselines ``p`` ``[n, 3]`` and ``w`` in
    wavelengths, on the inputs' device: the adjoint of :func:`idg_gridder`.

    Returns ``(vis [n] complex64, n_dropped)``; ``n_dropped`` is zero by
    construction on both routes (records off the grid predict 0 and are
    not counted).  The model grid must already be divided by the fine
    taper (``ops.idg.taper_fine``)."""
    _check_idg_support(subgrid, support)
    mr = _idg_unit_run_bound(grid_shape, subgrid, support)
    if mr is None:
        vis = idg_degrid_tile(grid_shape, p, w, grid, theta=theta,
                              subgrid=subgrid, support=support,
                              taper_beta=taper_beta)
        return vis, torch.zeros((), dtype=torch.int64, device=p.device)
    zer = torch.zeros((p.shape[0],), dtype=torch.int32, device=p.device)
    scr = torch.ones((1, subgrid, subgrid), dtype=torch.complex64,
                     device=p.device)
    return idg_aw_degridder_stream(
        grid_shape, p, zer, zer, w, grid, scr, theta=theta, subgrid=subgrid,
        support=support, taper_beta=taper_beta, max_runs=mr)


def idg_aw_gridder(grid_shape, p, a1, a2, w, vis, screens, *, theta: float,
                   subgrid: int = 64, support: int = 15,
                   taper_beta: float = 12.0, max_runs: int = 4096,
                   fit_margin: int = 0, ordered: bool = False):
    """IDG-AW gridding: image-domain antenna screens ``[nant, S, S]`` on
    (pair, uv-tile) runs, through the streamed CUDA gridder.

    ``ordered=True``: the caller guarantees a pair-major record stream, so
    the prep skips its sort; a poorly ordered stream overflows
    ``max_runs`` and the surplus is counted.  Returns ``(guv [N, Nx]
    complex64, n_dropped)``; callers must surface ``n_dropped``.  The grid
    lives in device memory, so there is no banded route.  Raises
    ``ValueError`` for an S the kernels do not take (odd, or outside 2 to
    128) or one whose fit margin is not positive."""
    check_subgrid(subgrid)
    return idg_aw_gridder_stream(
        grid_shape, p, a1, a2, w, vis, screens, theta=theta,
        subgrid=subgrid, support=support, taper_beta=taper_beta,
        max_runs=max_runs, fit_margin=fit_margin, ordered=ordered)


def idg_aw_degridder(grid_shape, p, a1, a2, w, grid, screens, *,
                     theta: float, subgrid: int = 64, support: int = 15,
                     taper_beta: float = 12.0, max_runs: int = 4096,
                     fit_margin: int = 0):
    """IDG-AW degridding (model predict with direction-dependent antenna
    terms), the exact adjoint of :func:`idg_aw_gridder`, through the
    streamed CUDA degridder.  Returns ``(vis [n] complex64, n_dropped)``;
    dropped records predict 0 and callers count them with
    :func:`note_drops`.  Takes the subgrids :func:`idg_aw_gridder`
    takes."""
    check_subgrid(subgrid)
    return idg_aw_degridder_stream(
        grid_shape, p, a1, a2, w, grid, screens, theta=theta,
        subgrid=subgrid, support=support, taper_beta=taper_beta,
        max_runs=max_runs, fit_margin=fit_margin)
