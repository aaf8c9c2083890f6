"""Multi-channel (spectral-cube) imaging (port of
``ska_sdp_tpu/models/spectral.py``).

Every channel is imaged at its own frequency.  Channel c's scaled
baselines are the reference channel's dilated by ``r = f_c/f_ref`` about the
grid centre, so within a channel GROUP the records are binned once at the
group's centre frequency and each channel applies an elementwise geometry
update (``idg_aw_records_for_channel`` / ``idg_records_for_channel``): N
channels cost one sort and N kernel launches.  Records a channel's drift
pushes out of their binning window are zeroed and counted.  Groups are
planned on the host from the data's uv extent (:func:`plan_channel_groups`).

  ==========================  ====================  ==============================
  path                        in memory             file
  ==========================  ====================  ==============================
  IDG cube                    ``idg_cube``          ``idg_gridding_multi``
  IDG-AW cube                 ``aw_idg_cube``       ``aw_idg_gridding_multi``
  w-projection cube           ``w_cube``            ``w_gridding_multi``
  IDG cube, sharded           ``idg_cube_sharded``  ``idg_gridding_multi_sharded``
  ==========================  ====================  ==============================

Plain IDG grids each channel through the streamed kernel with unit screens
(``csrc/idg_grid.cu``); where the reference's run-table test sends the
group to the fixed-tile prep, its occupied subgrids become the same
kernel's runs (``kernels/idg_tile.py``).  IDG-AW goes through the streamed
kernel with antenna screens; w-projection through the bank scatter
(``csrc/wproj_grid.cu``), which needs no binning.

Weighting: by default one uniform-weight histogram at the group's reference
channel serves every channel of the group; ``SKA_SDP_TPU_EXACT_WEIGHTS=1``
(read per call) takes one histogram per channel on its own scaled cells.

Outputs: the cube ``[nch, n, n]`` and its channel mean, the continuum image
(``/img``; the cube is ``/img_cube``).
"""

from __future__ import annotations

import math
import os
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ImagingConfig
from ..io import h5, schema
from ..io.inputs import VisData, get_akernels, get_wkernels, load_vis_data
from ..kernels import wproj_gridder
from ..kernels.idg_aw_records import (idg_aw_records_for_channel,
                                      idg_aw_run_records_multi)
from ..kernels.idg_aw_stream import (check_subgrid,
                                     idg_aw_grid_from_records_stream)
from ..kernels.idg_tile import (idg_bin_records_multi, idg_grid_from_records,
                                idg_records_for_channel)
from ..ops import (doweight, ifft_centered, make_grid_hermitian, uvw_lambda)
from ..ops.idg import fov_pad_geometry
from ..ops.search import find_closest
from ..types import precision as _precision
from ..utils import hostmem
from ..utils.timing import PhaseTimer, block_until_ready
from .dataset import (ant_ids, antenna_screens, bank_tensors,
                      detect_time_major_layout, id_tensors, idg_finish,
                      pair_count, vis_chunk)

C_LIGHT = 299792458.0
SUPPORT = 15
# The reference's run-table capacity (its SMEM CSR): a group whose tile
# bound exceeds it takes the fixed-tile prep.  The port keeps the test so
# that the branch, and with it every drop count, is the reference's.
RUN_TABLE_CAP = 24576


def plan_channel_groups(freqs, extent_cells: float, slack_cells: float):
    """Split channels into contiguous groups whose coordinate drift fits
    the per-channel recheck slack.

    For a group binned at its centre frequency f_ref, channel c's scaled
    coordinates dilate by r = f_c/f_ref; a record at ``extent_cells`` from
    the grid centre moves by |r − 1|·extent_cells cells.  A group is
    admissible when that stays ≤ ``slack_cells`` for every member.  Greedy
    left to right with halving.  Returns ``(start, stop, f_ref,
    drift_cells)`` tuples."""
    freqs = np.asarray(freqs, np.float64)
    nch = freqs.shape[0]
    groups = []
    i = 0
    while i < nch:
        j = nch
        while True:
            f_ref = 0.5 * (freqs[i] + freqs[j - 1])
            drift = float(
                np.max(np.abs(freqs[i:j] / f_ref - 1.0)) * extent_cells)
            if drift <= slack_cells or j == i + 1:
                break
            j = i + max(1, (j - i) // 2)
        groups.append((i, j, f_ref, int(math.ceil(drift))))
        i = j
    return groups


def uv_extent_cells(uvw, f_top: float, lam: float, n_grid: int) -> float:
    """Max |u|, |v| grid-cell distance from the grid centre at the highest
    frequency: the lever arm of per-channel coordinate drift."""
    uvw_l = np.asarray(uvw)[:, :2] * (f_top / C_LIGHT)
    if uvw_l.size == 0:
        return 0.0
    return float(np.max(np.abs(uvw_l)) / lam * n_grid)


def _exact_weights() -> bool:
    """``SKA_SDP_TPU_EXACT_WEIGHTS=1``: one uniform-weight histogram per
    channel (see :func:`group_inputs`); read per call."""
    return os.environ.get("SKA_SDP_TPU_EXACT_WEIGHTS", "0") == "1"


class CubeImage(NamedTuple):
    cube: torch.Tensor     # [nch, n, n] real, on the imaging device
    image: torch.Tensor    # [n, n] channel mean (the continuum image)
    image_max: float
    dropped: np.ndarray    # [nch] int64 channel-records dropped per channel
    groups: list           # (start, stop, f_ref, drift_cells) per group
    branches: tuple        # per group: "stream", "tile" or "wproj"


# ---------------------------------------------------------------------------
# group programs
# ---------------------------------------------------------------------------


def group_inputs(uvw, f_ref, ratios, vis_mc, *, theta: float, lam: int,
                 exact: bool):
    """A group's gridder inputs: uvw in wavelengths at the reference
    channel, mirrored into v ≥ 0 (by channel 0's geometry, which every
    channel shares), and each channel's weighted, mirrored visibilities
    ``[g, n]``.  Uniform weights come from one histogram at the reference
    channel or, with ``exact``, one per channel at ``uvw·r``."""
    uvw0 = uvw_lambda(f_ref, uvw)
    ones = torch.ones((uvw0.shape[0],), dtype=uvw0.dtype, device=uvw0.device)
    if exact:
        wts = torch.stack([doweight(theta, lam, uvw0 * r, ones).real
                           for r in ratios])
    else:
        wts = doweight(theta, lam, uvw0, ones).real[None, :]
    neg = uvw0[:, 1] < 0
    uvw1 = torch.where(neg[:, None], -uvw0, uvw0)
    vis1 = torch.where(neg[None, :], torch.conj(vis_mc), vis_mc)
    return uvw1, vis1 * wts.to(vis1.dtype)


def _idg_multi_pipeline(uvw, f_ref, ratios, vis_mc, *, theta: float,
                        lam: int, subgrid: int = 64, taper_beta: float = 12.0,
                        fov_pad: Optional[float] = None,
                        exact_weights: bool = False, drift_cells: int = 0):
    """One channel group through plain IDG on ``uvw``'s device: bin once,
    update per channel, grid, and per channel Hermitian completion, centred
    inverse FFT, division by the fine taper and the padded-FOV crop.

    ``ratios`` ``[g]`` (a tensor in ``uvw``'s dtype) are ``f_c/f_ref``.
    The branch is the reference's: the streamed kernel with unit screens
    and zero pair ids when the tile bound (from its fixed taper tail of 12
    cells) fits :data:`RUN_TABLE_CAP`, else the fixed-tile prep (on the
    same kernel, ``kernels/idg_tile.py``).  Returns
    ``(cube [g, n, n], masked [g] int64, branch)``; the streamed branch's
    counts include the prep's own drops."""
    n_t, n_grid, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    shape = (n_grid, n_grid)
    uvw1, vis1 = group_inputs(uvw, f_ref, ratios, vis_mc, theta=theta,
                              lam=lam, exact=exact_weights)
    p, w = uvw1 / lam, uvw1[:, 2]
    margin_full = subgrid // 2 - SUPPORT // 2 - 12
    tc = max(2 * (margin_full - drift_cells) - 2, 8)
    tile_bound = ((n_grid + 2 * subgrid) // tc + 2) ** 2 + 64
    r32 = ratios.to(torch.float32)
    imgs, masked = [], []
    if tile_bound <= RUN_TABLE_CAP:
        branch = "stream"
        zer = torch.zeros((p.shape[0],), dtype=torch.int32, device=p.device)
        (base, vis_s, st, en, y0, x0, i1, i2, nd0,
         _) = idg_aw_run_records_multi(
            shape, p, zer, zer, w, vis1.real, vis1.imag, subgrid=subgrid,
            support=SUPPORT, max_runs=tile_bound, drift_cells=drift_cells)
        unit = torch.ones((1, subgrid, subgrid), dtype=torch.complex64,
                          device=p.device)
        for c in range(vis_s.shape[0]):
            recs, nm = idg_aw_records_for_channel(base, vis_s[c], r32[c],
                                                  subgrid=subgrid)
            guv = idg_aw_grid_from_records_stream(
                recs, st, en, y0, x0, i1, i2, shape, unit, theta=theta_g,
                subgrid=subgrid, taper_beta=taper_beta)
            imgs.append(idg_finish(guv, n_t, n_grid, crop_lo, subgrid,
                                   taper_beta, uvw.dtype))
            masked.append(nm + nd0)
    else:
        branch = "tile"
        base, vis_s, starts = idg_bin_records_multi(
            shape, p, w, vis1.real, vis1.imag, subgrid=subgrid,
            support=SUPPORT)
        for c in range(vis_s.shape[0]):
            recs, nm = idg_records_for_channel(base, vis_s[c], r32[c],
                                               subgrid=subgrid)
            guv = idg_grid_from_records(recs, starts, shape, theta=theta_g,
                                        subgrid=subgrid,
                                        taper_beta=taper_beta)
            imgs.append(idg_finish(guv, n_t, n_grid, crop_lo, subgrid,
                                   taper_beta, uvw.dtype))
            masked.append(nm)
    return torch.stack(imgs), torch.stack(masked), branch


def _pair_major(x, layout, axis: int = 0):
    """The ``[ntime, nbl]`` record raster along ``axis`` relaid pair-major
    (a device transpose)."""
    ntime, nbl = layout
    xt = torch.movedim(x, axis, 0)
    rest = tuple(xt.shape[1:])
    xt = xt.reshape((ntime, nbl) + rest).transpose(0, 1).reshape(
        (ntime * nbl,) + rest)
    return torch.movedim(xt, 0, axis)


def _idg_aw_multi_pipeline(screens, uvw, a1, a2, f_ref, ratios, vis_mc, *,
                           theta: float, lam: int, subgrid: int = 64,
                           taper_beta: float = 12.0, max_runs: int = 4096,
                           drift_cells: int = 0,
                           fov_pad: Optional[float] = None, layout=None,
                           exact_weights: bool = False):
    """One channel group through IDG-AW (image-domain antenna screens
    ``[nant, S, S]``) on ``uvw``'s device: one (pair, uv-tile) run prep and
    per-channel updates through the streamed kernel.

    ``layout=(ntime, nbl)``: the records are a time-major raster,
    transposed to pair-major on the device so the prep skips its sort.
    Returns ``(cube [g, n, n], dropped [g] int64)``, each channel's count
    the prep's drops plus its own recheck's."""
    check_subgrid(subgrid)
    n_t, n_grid, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    shape = (n_grid, n_grid)
    uvw1, vis1 = group_inputs(uvw, f_ref, ratios, vis_mc, theta=theta,
                              lam=lam, exact=exact_weights)
    if layout is not None:
        uvw1 = _pair_major(uvw1, layout)
        a1, a2 = _pair_major(a1, layout), _pair_major(a2, layout)
        vis1 = _pair_major(vis1, layout, axis=1)
    (base, vis_s, st, en, y0, x0, i1, i2, nd0,
     _) = idg_aw_run_records_multi(
        shape, uvw1 / lam, a1, a2, uvw1[:, 2], vis1.real, vis1.imag,
        subgrid=subgrid, support=SUPPORT, max_runs=max_runs,
        drift_cells=drift_cells, ordered=layout is not None)
    scr = screens.to(torch.complex64).contiguous()
    r32 = ratios.to(torch.float32)
    imgs, dropped = [], []
    for c in range(vis_s.shape[0]):
        recs, nm = idg_aw_records_for_channel(base, vis_s[c], r32[c],
                                              subgrid=subgrid)
        guv = idg_aw_grid_from_records_stream(
            recs, st, en, y0, x0, i1, i2, shape, scr, theta=theta_g,
            subgrid=subgrid, taper_beta=taper_beta)
        imgs.append(idg_finish(guv, n_t, n_grid, crop_lo, subgrid,
                               taper_beta, uvw.dtype))
        dropped.append(nm + nd0)
    return torch.stack(imgs), torch.stack(dropped)


def _wproj_multi_pipeline(bank_conj, wbins, uvw, f_ref, ratios, vis_mc, *,
                          theta: float, lam: int, chunk: int = 8192,
                          exact_weights: bool = False):
    """One channel group through bank w-projection on ``uvw``'s device: the
    scatter needs no binning, so each channel scatters its scaled records
    (``p = uvw·r/lam``, the plane closest to ``w·r``) through the conjugated
    bank.  Returns the cube ``[g, n, n]``."""
    n_grid = int(round(theta * lam))
    uvw1, vis1 = group_inputs(uvw, f_ref, ratios, vis_mc, theta=theta,
                              lam=lam, exact=exact_weights)
    imgs = []
    for c in range(vis1.shape[0]):
        r = ratios[c]
        wbin = find_closest(wbins, uvw1[:, 2] * r)
        guv = wproj_gridder(bank_conj, (n_grid, n_grid), uvw1 * r / lam,
                            wbin, vis1[c], chunk=chunk)
        imgs.append(ifft_centered(make_grid_hermitian(guv)).real)
    return torch.stack(imgs)


# ---------------------------------------------------------------------------
# in-memory entries
# ---------------------------------------------------------------------------


def _surface_drops(dropped_per_chan, n: int, timer: PhaseTimer) -> None:
    """Record the total in ``timer.counters["multichannel/dropped"]`` and,
    when it is not 0, warn on stderr with the per-channel counts."""
    total = int(np.sum(dropped_per_chan))
    timer.counters["multichannel/dropped"] = float(total)
    if total > 0:
        print(
            f"warning: multi-channel run dropped {total} channel-records "
            f"({100.0 * total / max(n, 1):.3f}% of channel-visibilities) "
            "whose per-channel drift left their binning window — "
            "per-channel counts: "
            + ",".join(str(int(d)) for d in dropped_per_chan),
            file=sys.stderr,
        )


def _cube_inputs(vis_data: VisData, channels, n, prec, device):
    """``(n, freqs [nch] float64, uvw [n, 3], vis [nch, n])``: the first
    ``n`` records of the first ``channels`` channels (all when None), on
    ``device``."""
    if vis_data.vis_chan is None or vis_data.frequencies is None:
        raise ValueError("a spectral cube needs vis_chan and frequencies")
    n = n if n is not None else vis_data.vis.shape[0]
    nfreq = vis_data.frequencies.shape[0]
    nch = nfreq if channels is None else min(channels, nfreq)
    freqs = np.asarray(vis_data.frequencies[:nch], np.float64)
    uvw = hostmem.to_device(vis_data.uvw[:n], device, np_dtype=prec.np_real)
    vis = hostmem.to_device(vis_data.vis_chan[:n, :nch], device,
                            np_dtype=prec.np_complex)
    return n, freqs, uvw, vis.T.contiguous()


def _cube(imgs, drops, n, timer, groups, branches) -> CubeImage:
    """Assemble the :class:`CubeImage` from the groups' results and
    surface the drops."""
    cube = torch.cat(imgs)
    dropped = torch.cat(drops).cpu().numpy().astype(np.int64)
    _surface_drops(dropped, n, timer)
    image = cube.mean(dim=0)
    mx = float(image.max()) if image.numel() else 0.0
    return CubeImage(cube, image, mx, dropped, groups, tuple(branches))


def _ratios(freqs, i, j, f_ref, prec, device):
    return torch.as_tensor((freqs[i:j] / f_ref).astype(prec.np_real),
                           device=device)


def idg_cube(vis_data: VisData, *, channels: Optional[int] = None,
             theta: float = 0.008, lam: int = 300000,
             n: Optional[int] = None, subgrid: int = 64,
             taper_beta: float = 12.0, fov_pad: Optional[float] = None,
             precision: str = "single", device="cuda",
             timer: Optional[PhaseTimer] = None) -> CubeImage:
    """IDG spectral cube of in-memory visibilities (``vis_data.vis_chan``
    ``[n, nch]`` at ``vis_data.frequencies``) on ``device``: every channel at
    its own frequency, the binning shared per channel group.  Drops are
    recorded in ``timer.counters`` and warned about."""
    timer = timer or PhaseTimer()
    prec = _precision(precision)
    with timer.phase("host/prep"):
        n, freqs, uvw, vis = _cube_inputs(vis_data, channels, n, prec, device)
        _, n_grid, _, _ = fov_pad_geometry(theta, lam, fov_pad)
        ext = uv_extent_cells(vis_data.uvw[:n], float(freqs.max()), lam,
                              n_grid)
        # the per-channel recheck's slack in the run prep (the full margin
        # less the binning margin; the pipeline sizes its tiles from it)
        slack = (subgrid - SUPPORT) // 2 - subgrid // 4 - 1
        groups = plan_channel_groups(freqs, ext, max(slack, 1))
    exact = _exact_weights()
    imgs, drops, branches = [], [], []
    with timer.phase("compile+grid+fft"):
        for (i, j, f_ref, drift) in groups:
            img, masked, branch = _idg_multi_pipeline(
                uvw, f_ref, _ratios(freqs, i, j, f_ref, prec, uvw.device),
                vis[i:j], theta=theta, lam=lam, subgrid=subgrid,
                taper_beta=taper_beta, fov_pad=fov_pad, exact_weights=exact,
                drift_cells=drift)
            imgs.append(img)
            drops.append(masked)
            branches.append(branch)
        block_until_ready(imgs)
    return _cube(imgs, drops, n, timer, groups, branches)


def aw_idg_cube(vis_data: VisData, akerns, *, channels: Optional[int] = None,
                theta: float = 0.008, lam: int = 300000,
                n: Optional[int] = None, subgrid: int = 64,
                taper_beta: float = 12.0, fov_pad: Optional[float] = None,
                precision: str = "single", device="cuda",
                timer: Optional[PhaseTimer] = None) -> CubeImage:
    """IDG-AW spectral cube of in-memory visibilities on ``device``.
    ``akerns`` is the ``[nant, s, s]`` A-kernel stack, or a callable that
    returns it for a group's centre frequency (the file entry picks them at
    the closest time and frequency).  A time-major raster is detected on
    the host and relaid pair-major on the device, with no sort."""
    timer = timer or PhaseTimer()
    prec = _precision(precision)
    with timer.phase("host/prep"):
        n, freqs, uvw, vis = _cube_inputs(vis_data, channels, n, prec, device)
        a1, a2 = ant_ids(vis_data, n)
        a1_d, a2_d = id_tensors((a1, a2), uvw.device)
        npair = pair_count(a1_d, a2_d)
        n_t, n_grid, _, _ = fov_pad_geometry(theta, lam, fov_pad)
        layout = detect_time_major_layout(a1, a2, vis_data.time, n)
        ext = uv_extent_cells(vis_data.uvw[:n], float(freqs.max()), lam,
                              n_grid)
        margin_full = subgrid // 2 - SUPPORT // 2 - 12
        # up to half the taper margin as drift; tiles shrink to match
        groups = plan_channel_groups(freqs, ext, max(margin_full // 2, 1))
    exact = _exact_weights()
    imgs, drops = [], []
    with timer.phase("compile+grid+fft"):
        for (i, j, f_ref, drift) in groups:
            ak = akerns(f_ref) if callable(akerns) else akerns
            screens = antenna_screens(ak, subgrid, theta, lam, fov_pad,
                                      prec, uvw.device)
            # smaller tiles under drift: more runs per pair track
            tile_scale = max(1, (2 * margin_full - 2)
                             // max(2 * (margin_full - drift) - 2, 2))
            max_runs = 8 * npair * tile_scale + n // 128 + 64
            img, nd = _idg_aw_multi_pipeline(
                screens, uvw, a1_d, a2_d, f_ref,
                _ratios(freqs, i, j, f_ref, prec, uvw.device), vis[i:j],
                theta=theta, lam=lam, subgrid=subgrid,
                taper_beta=taper_beta, max_runs=max_runs, drift_cells=drift,
                fov_pad=fov_pad, layout=layout, exact_weights=exact)
            imgs.append(img)
            drops.append(nd)
        block_until_ready(imgs)
    return _cube(imgs, drops, n, timer, groups, ["stream"] * len(groups))


def w_cube(vis_data: VisData, wkerns, wbins, *,
           channels: Optional[int] = None, theta: float = 0.008,
           lam: int = 300000, n: Optional[int] = None,
           precision: str = "single", device="cuda",
           timer: Optional[PhaseTimer] = None) -> CubeImage:
    """w-projection spectral cube of in-memory visibilities through the
    unconjugated bank ``wkerns`` ``[nw, qpx, qpx, s, s]`` with plane centres
    ``wbins`` on ``device``.  One group: the scatter has no binning for the
    channels to drift out of; each channel picks its planes at ``w·r``."""
    timer = timer or PhaseTimer()
    prec = _precision(precision)
    with timer.phase("host/prep"):
        n, freqs, uvw, vis = _cube_inputs(vis_data, channels, n, prec, device)
        bank, wb = bank_tensors(wkerns, wbins, prec, uvw.device)
        f_ref = 0.5 * (freqs[0] + freqs[-1])
    with timer.phase("compile+grid+fft"):
        cube = _wproj_multi_pipeline(
            torch.conj(bank).resolve_conj(), wb, uvw, f_ref,
            _ratios(freqs, 0, freqs.shape[0], f_ref, prec, uvw.device), vis,
            theta=theta, lam=lam, chunk=vis_chunk(n),
            exact_weights=_exact_weights())
        block_until_ready(cube)
    nch = freqs.shape[0]
    zero = torch.zeros((nch,), dtype=torch.int64)
    return _cube([cube], [zero], n, timer, [(0, nch, f_ref, 0)], ["wproj"])


def idg_cube_sharded(vis_data: VisData, mesh, *,
                     channels: Optional[int] = None, theta: float = 0.008,
                     lam: int = 300000, n: Optional[int] = None,
                     subgrid: int = 64, taper_beta: float = 12.0,
                     precision: str = "single",
                     timer: Optional[PhaseTimer] = None) -> CubeImage:
    """IDG spectral cube sharded over the ranks of ``mesh``
    (``parallel.Mesh``), on each rank's device: every rank calls it with
    the same ``vis_data`` and grids its own block of records
    (``parallel.make_sharded_spectral_idg_step``, one all-reduce a
    channel); the cube is on every rank.

    Each channel is gridded at its own coordinates, the reference channel's
    dilated (no shared binning, so nothing is dropped), while the uniform
    weights stay the group's: one histogram at its reference channel,
    summed over the ranks.  The records are padded to a multiple of the
    mesh size with mask 0, so any record count is exact."""
    from ..parallel.mesh import pad_to_multiple, shard_range
    from ..parallel.sharded import make_sharded_spectral_idg_step

    timer = timer or PhaseTimer()
    prec = _precision(precision)
    if vis_data.vis_chan is None or vis_data.frequencies is None:
        raise ValueError("a spectral cube needs vis_chan and frequencies")
    with timer.phase("host/prep"):
        n = n if n is not None else vis_data.vis.shape[0]
        nfreq = vis_data.frequencies.shape[0]
        nch = nfreq if channels is None else min(channels, nfreq)
        freqs = np.asarray(vis_data.frequencies[:nch], np.float64)
        n_pad = pad_to_multiple(n, mesh.size)
        sl = shard_range(n_pad, mesh)
        uvw_h = np.zeros((n_pad, 3), prec.np_real)
        uvw_h[:n] = np.asarray(vis_data.uvw[:n], prec.np_real)
        mask_h = np.zeros((n_pad,), prec.np_real)
        mask_h[:n] = 1.0
        vis_h = np.zeros((nch, n_pad), prec.np_complex)
        vis_h[:, :n] = vis_data.vis_chan[:n, :nch].T
        n_grid = int(round(theta * lam))
        ext = uv_extent_cells(vis_data.uvw[:n], float(freqs.max()), lam,
                              n_grid)
        # the local driver's group plan, so the weights are shared alike
        slack = (subgrid - SUPPORT) // 2 - subgrid // 4 - 1
        groups = plan_channel_groups(freqs, ext, max(slack, 1))
    with timer.phase("h2d/shard"):
        uvw = hostmem.to_device(uvw_h[sl], mesh.device)
        mask = hostmem.to_device(mask_h[sl], mesh.device)
        vis = hostmem.to_device(vis_h[:, sl], mesh.device,
                                np_dtype=prec.np_complex)
    imgs = []
    with timer.phase("compile+grid+fft"):
        for (i, j, f_ref, _) in groups:
            step = make_sharded_spectral_idg_step(
                mesh, theta, lam, j - i, subgrid=subgrid,
                taper_beta=taper_beta)
            imgs.append(step(uvw, mask, float(np.asarray(f_ref, prec.np_real)),
                             _ratios(freqs, i, j, f_ref, prec, mesh.device),
                             vis[i:j]))
        block_until_ready(imgs)
    zero = torch.zeros((nch,), dtype=torch.int64)
    return _cube(imgs, [zero], n, timer, groups, ["sharded"] * len(groups))


# ---------------------------------------------------------------------------
# file entries
# ---------------------------------------------------------------------------


def _finish_cube(cube: np.ndarray, outfile: Optional[str],
                 timer: PhaseTimer):
    """``(continuum max, continuum image)``; writes ``/img`` (the channel
    mean) and ``/img_cube``, both float64, when ``outfile`` is given."""
    img_mean = cube.mean(axis=0)
    mx = float(img_mean.max()) if img_mean.size else 0.0
    if outfile is not None:
        with timer.phase("write/img"):
            h5.create_file(outfile)
            h5.write_dataset(outfile, schema.IMG_DATASET,
                             np.asarray(img_mean, np.float64))
            h5.write_dataset(outfile, schema.IMG_CUBE_DATASET,
                             np.asarray(cube, np.float64))
    return mx, img_mean


def _file_result(res: CubeImage, outfile, timer):
    with timer.phase("d2h/cube"):
        cube = res.cube.cpu().numpy()
    mx, img_mean = _finish_cube(cube, outfile, timer)
    return mx, img_mean, cube


def idg_gridding_multi(datfile: str, channels: int, n: Optional[int] = None,
                       outfile: Optional[str] = None,
                       config: ImagingConfig = ImagingConfig(),
                       timer: Optional[PhaseTimer] = None,
                       subgrid: int = 64, taper_beta: float = 12.0,
                       fov_pad: Optional[float] = None, device="cuda"):
    """Multi-channel IDG imaging run from an HDF5 file on ``device``.
    Returns ``(continuum max, continuum image, cube [nch, n, n])`` as
    numpy and optionally writes ``/img`` and ``/img_cube``."""
    timer = timer or PhaseTimer()
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    res = idg_cube(data, channels=channels, theta=config.grid.theta,
                   lam=config.grid.lam, n=n, subgrid=subgrid,
                   taper_beta=taper_beta, fov_pad=fov_pad,
                   precision=config.precision_name, device=device,
                   timer=timer)
    return _file_result(res, outfile, timer)


def idg_gridding_multi_sharded(datfile: str, channels: int,
                               n: Optional[int] = None,
                               outfile: Optional[str] = None,
                               config: ImagingConfig = ImagingConfig(),
                               timer: Optional[PhaseTimer] = None,
                               subgrid: int = 64, taper_beta: float = 12.0,
                               mesh=None):
    """Multi-channel IDG imaging run from an HDF5 file, sharded over
    ``mesh`` (default ``parallel.make_mesh()``): every rank reads the file
    and calls :func:`idg_cube_sharded`; only rank 0 writes ``/img`` and
    ``/img_cube``.  Returns ``(continuum max, continuum image, cube)`` on
    every rank."""
    from ..parallel.mesh import make_mesh

    timer = timer or PhaseTimer()
    mesh = mesh if mesh is not None else make_mesh()
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    res = idg_cube_sharded(data, mesh, channels=channels,
                           theta=config.grid.theta, lam=config.grid.lam, n=n,
                           subgrid=subgrid, taper_beta=taper_beta,
                           precision=config.precision_name, timer=timer)
    return _file_result(res, outfile if mesh.rank == 0 else None, timer)


def aw_idg_gridding_multi(afile: str, datfile: str, channels: int,
                          n: Optional[int] = None,
                          outfile: Optional[str] = None,
                          config: ImagingConfig = ImagingConfig(),
                          timer: Optional[PhaseTimer] = None,
                          subgrid: int = 64, taper_beta: float = 12.0,
                          fov_pad: Optional[float] = None, device="cuda"):
    """Multi-channel IDG-AW imaging run from HDF5 files on ``device``:
    A-kernels at the data's first time and each group's centre frequency
    (closest slots).  Returns ``(continuum max, continuum image, cube)``."""
    timer = timer or PhaseTimer()
    theta = config.grid.theta
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)

    def akerns(f_ref):
        return get_akernels(afile, theta, float(data.time[0]), f_ref)

    res = aw_idg_cube(data, akerns, channels=channels, theta=theta,
                      lam=config.grid.lam, n=n, subgrid=subgrid,
                      taper_beta=taper_beta, fov_pad=fov_pad,
                      precision=config.precision_name, device=device,
                      timer=timer)
    return _file_result(res, outfile, timer)


def w_gridding_multi(wfile: str, datfile: str, channels: int,
                     n: Optional[int] = None, outfile: Optional[str] = None,
                     config: ImagingConfig = ImagingConfig(),
                     timer: Optional[PhaseTimer] = None, device="cuda"):
    """Multi-channel w-projection imaging run from HDF5 files on
    ``device``.  Returns ``(continuum max, continuum image, cube)``."""
    timer = timer or PhaseTimer()
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/wkern"):
        wkerns, wbins = get_wkernels(wfile, config.grid.theta)
    res = w_cube(data, wkerns, wbins, channels=channels,
                 theta=config.grid.theta, lam=config.grid.lam, n=n,
                 precision=config.precision_name, device=device, timer=timer)
    return _file_result(res, outfile, timer)
