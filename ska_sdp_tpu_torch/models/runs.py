"""File runs (port of the file entries of ``ska_sdp_tpu/models/dataset.py``):
each reads HDF5 (``io.inputs``), calls the in-memory entry that
``models.dataset``'s table names, writes HDF5 and records the reference's
phase names in a ``PhaseTimer``.  ``device_phases=True`` times an imaging
program's own stages (``models.dataset``'s prep and finish functions) one
by one on the reference's staged route (``--device-phases``).  The
checkpointed and out-of-core runs bind the slab callback to
``utils.checkpoint.save`` and resume from its file.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ImagingConfig
from ..io import h5, schema
from ..io.inputs import (flat_vis_reader, get_akernels, get_wkernels,
                         load_vis_data, require_file, vis_record_geometry)
from ..kernels import note_drops, wproj_gridder
from ..kernels.idg_aw_records import idg_aw_run_records
from ..kernels.idg_aw_stream import (check_subgrid,
                                     idg_aw_grid_from_records_stream)
from ..kernels.idg_tile import idg_bin_records, idg_grid_from_records
from ..utils import checkpoint as ckpt
from ..utils.hostmem import HostCopy
from ..utils.timing import PhaseTimer
from . import dataset as ds
from .imaging import aw_imaging


def write_image(outfile: Optional[str], img: np.ndarray,
                timer: PhaseTimer) -> None:
    """``/img`` of ``outfile`` as float64, when ``outfile`` is given."""
    if outfile is not None:
        with timer.phase("write/img"):
            h5.create_file(outfile)
            h5.write_dataset(outfile, schema.IMG_DATASET,
                             img.astype(np.float64))


def _write_prediction(outfile: Optional[str], pred: np.ndarray,
                      timer: PhaseTimer, phase: str = "write/vis") -> None:
    if outfile is not None:
        with timer.phase(phase):
            h5.create_file(outfile)
            h5.write_dataset(outfile, schema.MODEL_VIS_DATASET,
                             pred.astype(np.complex128))


# ---------------------------------------------------------------------------
# Staged programs (--device-phases)
# ---------------------------------------------------------------------------


def idg_staged(uvw: torch.Tensor, f: torch.Tensor, vis: torch.Tensor, *,
               theta: float, lam: int, subgrid: int, taper_beta: float,
               timer: PhaseTimer, fov_pad: Optional[float] = None):
    """The IDG imaging program on ``uvw``'s device as four separately
    synchronised stages, timed by ``timer.device_stage``: ``preprocess``
    (``idg_grid_inputs``), ``bin+sort`` (the fixed-tile prep),
    ``idg-kernel+fold`` (the fixed-tile route's gridder) and
    ``hermitian+ifft+taper`` (``idg_grid_image``); ``fov_pad`` as in
    ``idg_pipeline``.  Every stage runs twice (warm-up, then timed).
    Returns ``(img, image max)``."""
    timer.dispatch_floor(uvw.device)
    g = timer.device_stage("preprocess", ds.idg_grid_inputs, uvw, f, vis,
                           theta=theta, lam=lam, fov_pad=fov_pad)
    recs, starts = timer.device_stage(
        "bin+sort", idg_bin_records, g.grid_shape, g.p, g.w, g.vis.real,
        g.vis.imag, subgrid=subgrid)
    guv = timer.device_stage(
        "idg-kernel+fold", idg_grid_from_records, recs, starts, g.grid_shape,
        theta=g.theta, subgrid=subgrid, taper_beta=taper_beta)
    img, mx = timer.device_stage("hermitian+ifft+taper", ds.idg_grid_image,
                                 guv, g, subgrid, taper_beta, uvw.dtype)
    return img, float(mx)


def aw_idg_staged(screens, uvw, a1, a2, f, vis, *, theta: float, lam: int,
                  subgrid: int, taper_beta: float, max_runs: int,
                  timer: PhaseTimer, fov_pad: Optional[float] = None):
    """The IDG-AW imaging program on ``uvw``'s device as four separately
    synchronised stages, timed by ``timer.device_stage``: ``preprocess``
    (``idg_grid_inputs``), ``run-sort`` (the streamed gridder's (pair,
    uv-tile) run prep, always sorting: the raster shortcut of
    ``aw_idg_image`` is not taken), ``idg-aw-kernel`` (the streamed
    gridder) and ``hermitian+ifft+taper`` (``idg_grid_image``);
    ``fov_pad`` as in ``aw_idg_pipeline``.  Returns ``(img, image max,
    n_dropped)``."""
    check_subgrid(subgrid)
    timer.dispatch_floor(uvw.device)
    g = timer.device_stage("preprocess", ds.idg_grid_inputs, uvw, f, vis,
                           theta=theta, lam=lam, fov_pad=fov_pad)
    recs = timer.device_stage(
        "run-sort", idg_aw_run_records, g.grid_shape, g.p, a1, a2, g.w,
        g.vis.real, g.vis.imag, subgrid=subgrid, max_runs=max_runs,
        nant=screens.shape[0])
    guv = timer.device_stage(
        "idg-aw-kernel", idg_aw_grid_from_records_stream, *recs[:7],
        g.grid_shape, screens.to(torch.complex64).contiguous(),
        theta=g.theta, subgrid=subgrid, taper_beta=taper_beta)
    img, mx = timer.device_stage("hermitian+ifft+taper", ds.idg_grid_image,
                                 guv, g, subgrid, taper_beta, uvw.dtype)
    return img, float(mx), int(recs[7])


def aw_fused_staged(wkerns, wbins, akerns, uvw, a1, a2, f, vis, *,
                    theta: float, lam: int, chunk: int, timer: PhaseTimer):
    """The fused AW imaging program (``aw_pipeline``) on ``uvw``'s device
    as three separately synchronised stages: ``preprocess``
    (``weighted_mirrored``), ``aw-fused-kernel`` (the fused AW gridder)
    and ``hermitian+ifft`` (``hermitian_image``).  Returns ``(img, image
    max)``."""
    timer.dispatch_floor(uvw.device)
    uvw1, wvis = timer.device_stage("preprocess", ds.weighted_mirrored, uvw,
                                    f, vis, theta=theta, lam=lam)
    guv = timer.device_stage("aw-fused-kernel", aw_imaging, theta, lam,
                             wkerns, wbins, akerns, uvw1, (a1, a2), wvis,
                             chunk=chunk)
    img, mx = timer.device_stage("hermitian+ifft", ds.hermitian_image, guv)
    return img, float(mx)


def wproj_staged(bank_conj, wbins, uvw, f, vis, *, theta: float, lam: int,
                 chunk: int, timer: PhaseTimer,
                 dump_to: Optional[str] = None):
    """The w-projection imaging program (``wproj_pipeline``) on ``uvw``'s
    device as three separately synchronised stages, timed by
    ``timer.device_stage``: ``preprocess`` (``wproj_grid_inputs``),
    ``scatter`` (the bank scatter into a zero grid) and ``hermitian+ifft``
    (``hermitian_image``).  ``dump_to`` writes the ``/debug`` tree: the
    uv-grid planes ``uvgrid_re``/``uvgrid_im`` and the image ``img`` as
    float32, the planes ``wbin`` as int32.  Returns ``(img, image
    max)``."""
    timer.dispatch_floor(uvw.device)
    shape, p, wbin, vis1 = timer.device_stage(
        "preprocess", ds.wproj_grid_inputs, uvw, f, vis, wbins, theta=theta,
        lam=lam)
    guv = timer.device_stage("scatter", wproj_gridder, bank_conj, shape, p,
                             wbin, vis1, chunk=chunk)
    img, mx = timer.device_stage("hermitian+ifft", ds.hermitian_image, guv)
    if dump_to is not None:
        h5.create_file(dump_to)
        for name, arr in (("uvgrid_re", guv.real.to(torch.float32)),
                          ("uvgrid_im", guv.imag.to(torch.float32)),
                          ("wbin", wbin.to(torch.int32)),
                          ("img", img.to(torch.float32))):
            h5.write_dataset(dump_to, f"/debug/{name}", arr.cpu().numpy())
    return img, float(mx)


# ---------------------------------------------------------------------------
# Imaging runs
# ---------------------------------------------------------------------------


def idg_gridding(datfile: str, n: Optional[int] = None,
                 outfile: Optional[str] = None,
                 config: ImagingConfig = ImagingConfig(),
                 timer: Optional[PhaseTimer] = None,
                 subgrid: int = 64, taper_beta: float = 12.0,
                 fov_pad: Optional[float] = None,
                 device_phases: bool = False, device="cuda"):
    """IDG imaging run from an HDF5 file: load ``/vis``, image on
    ``device``, optionally write ``/img`` (float64).  ``device_phases``
    runs the stage-synchronised :func:`idg_staged` (through the
    fixed-tile route, whatever the subgrid) and records its stage times
    in ``timer``.  Returns ``(image max, image as numpy)``."""
    timer = timer or PhaseTimer()
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    if device_phases:
        uvw, f, vis = ds.idg_inputs(data, n=n,
                                    precision=config.precision_name,
                                    device=device)
        img_t, mx = idg_staged(uvw, f, vis, theta=config.grid.theta,
                               lam=config.grid.lam, subgrid=subgrid,
                               taper_beta=taper_beta, timer=timer,
                               fov_pad=fov_pad)
        img = img_t.cpu().numpy()
    else:
        with timer.phase("h2d+compile+grid+fft"):
            res = ds.idg_image(data, theta=config.grid.theta,
                               lam=config.grid.lam, n=n, subgrid=subgrid,
                               taper_beta=taper_beta, fov_pad=fov_pad,
                               precision=config.precision_name,
                               device=device)
            img, mx = res.image.cpu().numpy(), res.image_max
    write_image(outfile, img, timer)
    return mx, img


def aw_gridding(wfile: Optional[str], afile: str, datfile: str,
                n: Optional[int] = None, outfile: Optional[str] = None,
                config: ImagingConfig = ImagingConfig(),
                timer: Optional[PhaseTimer] = None,
                idg: bool = False, fov_pad: Optional[float] = None,
                subgrid: int = 64, device_phases: bool = False,
                device="cuda"):
    """AW imaging run from HDF5 files, the reference's argument order.
    ``idg=False`` is fused AW-projection (``aw_image``: the ``wfile``
    bank, A-kernels from ``afile`` at the data's first time and its
    frequency).  ``idg=True`` is IDG-AW (``aw_idg_image``, screens from
    the same A-kernels; ``wfile`` may be None); its dropped records are
    warned about and set ``timer.counters["idg_aw/dropped"]``.
    ``device_phases`` runs :func:`aw_fused_staged` or
    :func:`aw_idg_staged` on the entries' own inputs and records their
    stage times in ``timer``.  Returns ``(image max, image as numpy)`` and
    optionally writes ``/img``."""
    timer = timer or PhaseTimer()
    theta, lam = config.grid.theta, config.grid.lam
    prec = config.precision
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/akern"):
        akerns = get_akernels(afile, theta, float(data.time[0]),
                              data.frequency)
    if not idg:
        if wfile is None:
            raise ValueError("fused AW imaging needs a w-kernel file")
        with timer.phase("ingest/wkern"):
            wkerns, wbins = get_wkernels(wfile, theta)
    n = n if n is not None else data.vis.shape[0]
    with timer.phase("h2d+compile+grid+fft"):
        if idg and device_phases:
            _, ak, uvw, f, vis, a1, a2 = ds.aw_idg_inputs(
                data, akerns, n=n, prec=prec, device=device)
            img_t, mx, nd = aw_idg_staged(
                ds.antenna_screens(ak, subgrid, theta, lam, fov_pad, prec,
                                   device), uvw, a1, a2, f, vis,
                theta=theta, lam=lam, subgrid=subgrid, taper_beta=12.0,
                max_runs=ds.aw_run_bound(a1, a2, n), timer=timer,
                fov_pad=fov_pad)
            note_drops("idg_aw_gridder", nd, ds.AW_DROP_REASON)
        elif idg:
            img_t, mx, nd = ds.aw_idg_image(
                data, akerns, theta=theta, lam=lam, n=n, subgrid=subgrid,
                fov_pad=fov_pad, precision=prec, device=device)
        elif device_phases:
            bank, wb, ak, uvw, f, vis, a1, a2 = ds.aw_inputs(
                data, wkerns, wbins, akerns, n=n, prec=prec, device=device)
            img_t, mx = aw_fused_staged(
                bank, wb, ak, uvw, a1, a2, f, vis, theta=theta, lam=lam,
                chunk=ds.vis_chunk(n), timer=timer)
        else:
            img_t, mx = ds.aw_image(data, wkerns, wbins, akerns, theta=theta,
                                    lam=lam, n=n, precision=prec,
                                    device=device)
        img = img_t.cpu().numpy()
    if idg:
        timer.counters["idg_aw/dropped"] = float(nd)
    write_image(outfile, img, timer)
    return mx, img


def w_gridding(wfile: str, datfile: str, n: Optional[int] = None,
               outfile: Optional[str] = None,
               config: ImagingConfig = ImagingConfig(),
               timer: Optional[PhaseTimer] = None,
               device_phases: bool = False,
               dump_intermediates: Optional[str] = None, device="cuda"):
    """w-projection imaging run from HDF5 files: ``/vis`` and the
    ``/wkern`` bank in, optionally ``/img`` (float64) out.
    ``device_phases`` or ``dump_intermediates`` (a file for the ``/debug``
    tree) runs the stage-synchronised :func:`wproj_staged`.  Returns
    ``(image max, image as numpy)``."""
    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/wkern"):
        wkerns, wbins = get_wkernels(wfile, theta)
    if device_phases or dump_intermediates:
        uvw, f, vis = ds.idg_inputs(data, n=n, precision=prec, device=device)
        bank, wb = ds.bank_tensors(wkerns, wbins, prec, device)
        img_t, mx = wproj_staged(
            torch.conj(bank).resolve_conj(), wb, uvw, f, vis, theta=theta,
            lam=lam, chunk=ds.vis_chunk(vis.shape[0]), timer=timer,
            dump_to=dump_intermediates)
        img = img_t.cpu().numpy()
    else:
        with timer.phase("h2d+compile+grid+fft"):
            res = ds.w_image(data, wkerns, wbins, theta=theta, lam=lam, n=n,
                             precision=prec, device=device)
            img, mx = res.image.cpu().numpy(), res.image_max
    write_image(outfile, img, timer)
    return mx, img


def psf_gridding(mode: str, datfile: str, n: Optional[int] = None,
                 outfile: Optional[str] = None,
                 config: ImagingConfig = ImagingConfig(),
                 timer: Optional[PhaseTimer] = None,
                 wstep: float = 2000.0, device="cuda"):
    """PSF-normalised imaging run from an HDF5 file: ``/vis`` in,
    optionally ``/img`` (the normalised image, in the run's precision, as
    the reference writes it) out.  Returns ``(PSF peak, image as
    numpy)``."""
    timer = timer or PhaseTimer()
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("h2d+compile+grid+fft"):
        res = ds.psf_image(data, mode, theta=config.grid.theta,
                           lam=config.grid.lam, n=n, wstep=wstep,
                           precision=config.precision_name, device=device)
        img = res.image.cpu().numpy()
    if outfile is not None:
        with timer.phase("write/img"):
            h5.create_file(outfile)
            h5.write_dataset(outfile, schema.IMG_DATASET, img)
    return float(res.pmax), img


# ---------------------------------------------------------------------------
# Prediction runs
# ---------------------------------------------------------------------------


def idg_predict(datfile: str, modelfile: str, n: Optional[int] = None,
                outfile: Optional[str] = None,
                config: ImagingConfig = ImagingConfig(),
                timer: Optional[PhaseTimer] = None, subgrid: int = 32,
                taper_beta: float = 12.0, fov_pad: Optional[float] = None,
                device="cuda"):
    """IDG prediction run from HDF5 files: ``/vis`` records and the
    ``/img`` model in, ``/vis/model`` out.  The default ``subgrid=32`` is
    the reference's; with support 15 it runs on the fixed-tile route.
    Returns ``(predicted ndarray, peak |vis|)``."""
    timer = timer or PhaseTimer()
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/model"):
        img = h5.read_dataset(modelfile, schema.IMG_DATASET)
    with timer.phase("h2d+compile+fft+degrid"):
        res = ds.idg_predict_vis(data, img, theta=config.grid.theta,
                                 lam=config.grid.lam, n=n, subgrid=subgrid,
                                 taper_beta=taper_beta, fov_pad=fov_pad,
                                 precision=config.precision_name,
                                 device=device)
        pred = res.vis.cpu().numpy()
    _write_prediction(outfile, pred, timer)
    return pred, res.peak


def aw_predict(afile: str, datfile: str, modelfile: str,
               n: Optional[int] = None, outfile: Optional[str] = None,
               config: ImagingConfig = ImagingConfig(),
               timer: Optional[PhaseTimer] = None, subgrid: int = 64,
               taper_beta: float = 12.0, fov_pad: Optional[float] = None,
               device="cuda"):
    """IDG-AW prediction run from HDF5 files (screens from the akern file
    at the data's first time and its frequency).  Dropped records set
    ``timer.counters["idg_aw/dropped"]``.  Returns ``(predicted ndarray,
    peak |vis|)`` and optionally writes ``/vis/model``."""
    timer = timer or PhaseTimer()
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/akern"):
        akerns = get_akernels(afile, config.grid.theta, float(data.time[0]),
                              data.frequency)
    with timer.phase("ingest/model"):
        img = h5.read_dataset(modelfile, schema.IMG_DATASET)
    with timer.phase("h2d+compile+fft+degrid"):
        res = ds.aw_predict_vis(data, akerns, img, theta=config.grid.theta,
                                lam=config.grid.lam, n=n, subgrid=subgrid,
                                taper_beta=taper_beta, fov_pad=fov_pad,
                                precision=config.precision_name,
                                device=device)
        pred = res.vis.cpu().numpy()
    timer.counters["idg_aw/dropped"] = float(res.n_dropped)
    _write_prediction(outfile, pred, timer)
    return pred, res.peak


def w_predict(wfile: str, datfile: str, modelfile: str,
              n: Optional[int] = None, outfile: Optional[str] = None,
              config: ImagingConfig = ImagingConfig(),
              timer: Optional[PhaseTimer] = None, device="cuda"):
    """w-projection prediction run from HDF5 files: ``/vis`` records, the
    ``/wkern`` bank and the ``/img`` model in, ``/vis/model`` out.
    Returns ``(predicted ndarray, peak |vis|)``."""
    timer = timer or PhaseTimer()
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/wkern"):
        wkerns, wbins = get_wkernels(wfile, config.grid.theta)
    with timer.phase("ingest/model"):
        img = h5.read_dataset(modelfile, schema.IMG_DATASET)
    with timer.phase("h2d+compile+fft+degrid"):
        res = ds.w_predict_vis(data, wkerns, wbins, img,
                               theta=config.grid.theta, lam=config.grid.lam,
                               n=n, precision=config.precision_name,
                               device=device)
        pred = res.vis.cpu().numpy()
    _write_prediction(outfile, pred, timer, "write/model-vis")
    return pred, res.peak


# ---------------------------------------------------------------------------
# Checkpointed and out-of-core (streamed) w-projection runs
# ---------------------------------------------------------------------------


def _checkpointing(path: str, n: int, theta: float, lam: int, wkerns,
                   prec, route: str):
    """``(start, grid, on_slab)`` of a checkpointed w-projection run: the
    state in the checkpoint ``path`` if it belongs to this run (the
    reference's fingerprint, so a checkpoint resumes across the two
    packages), else ``(0, None)``, and the callback that copies the device
    grid to the host (``utils.hostmem.HostCopy``) and writes it to
    ``path`` at the run's real precision."""
    shape = tuple(int(d) for d in np.shape(wkerns))
    fpr = ckpt.fingerprint(theta, lam, shape, str(prec.np_real), route)
    copy = HostCopy()

    def write(grid: torch.Tensor, nxt: int) -> None:
        g = copy(grid)
        ckpt.save(path, g.real.astype(prec.np_real),
                  g.imag.astype(prec.np_real), nxt, n, fpr=fpr)

    state = ckpt.load(path, int(round(theta * lam)), n, fpr=fpr)
    if state is None:
        return 0, None, write
    g_re, g_im, start = state
    return start, (g_re.astype(prec.np_real) + 1j * g_im.astype(
        prec.np_real)).astype(prec.np_complex), write


def _checkpointed_result(res, outfile, checkpoint: str, timer: PhaseTimer):
    """``(None, None)`` for a run stopped early; else the image written
    and the checkpoint removed: ``(image max, image as numpy)``."""
    if res is None:
        return None, None
    img = res.image.cpu().numpy()
    write_image(outfile, img, timer)
    ckpt.remove(checkpoint)
    return res.image_max, img


def w_gridding_checkpointed(wfile: str, datfile: str, checkpoint: str,
                            n: Optional[int] = None,
                            outfile: Optional[str] = None,
                            slab: int = 1 << 20,
                            config: ImagingConfig = ImagingConfig(),
                            timer: Optional[PhaseTimer] = None,
                            _max_slabs: Optional[int] = None,
                            device="cuda"):
    """Resumable w-projection imaging run from HDF5 files: after every
    ``slab`` records the uv-grid is written atomically to ``checkpoint``
    (``w_image_slabs``); a run finding a checkpoint of the same
    configuration resumes from it, and the file is removed on success.
    ``_max_slabs`` stops early (a test's interruption).  Returns ``(image
    max, image as numpy)``, or ``(None, None)`` when stopped early."""
    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/wkern"):
        wkerns, wbins = get_wkernels(wfile, theta)
    n = min(n, data.vis.shape[0]) if n is not None else data.vis.shape[0]
    start, grid, on_slab = _checkpointing(checkpoint, n, theta, lam, wkerns,
                                          prec, "wproj")
    res = ds.w_image_slabs(data, wkerns, wbins, theta=theta, lam=lam, n=n,
                           slab=slab, precision=prec, device=device,
                           start=start, grid=grid, on_slab=on_slab,
                           max_slabs=_max_slabs, timer=timer)
    return _checkpointed_result(res, outfile, checkpoint, timer)


def w_gridding_out_of_core(wfile: str, datfile: str, checkpoint: str,
                           n: Optional[int] = None,
                           outfile: Optional[str] = None,
                           slab: int = 1 << 20,
                           config: ImagingConfig = ImagingConfig(),
                           timer: Optional[PhaseTimer] = None,
                           _max_slabs: Optional[int] = None,
                           device="cuda"):
    """Streamed w-projection imaging of a dataset larger than host memory:
    ``w_image_streamed`` over slab readers of the vis file (HDF5 reads on
    a prefetch thread overlap the gridding), checkpointed after every
    slab as :func:`w_gridding_checkpointed` is, with the route
    ``"wproj-ooc"`` in the fingerprint.  Returns ``(image max, image as
    numpy)``, or ``(None, None)`` when ``_max_slabs`` stopped it."""
    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    require_file(datfile)
    n_total, per_row, nch = vis_record_geometry(datfile)
    n = min(n, n_total) if n is not None else n_total
    freq = float(h5.read_dataset(datfile, schema.VIS_FREQUENCY).ravel()[0])
    with timer.phase("ingest/wkern"):
        wkerns, wbins = get_wkernels(wfile, theta)
    readers = {"uvw": lambda s0, c: h5.read_dataset_slice(
                   datfile, schema.VIS_UVW, s0, c),
               "vis": flat_vis_reader(datfile, per_row, nch)}
    start, grid, on_slab = _checkpointing(checkpoint, n, theta, lam, wkerns,
                                          prec, "wproj-ooc")
    res = ds.w_image_streamed(readers, n, freq, wkerns, wbins, theta=theta,
                              lam=lam, slab=slab, precision=prec,
                              device=device, start=start, grid=grid,
                              on_slab=on_slab, max_slabs=_max_slabs,
                              timer=timer)
    return _checkpointed_result(res, outfile, checkpoint, timer)
