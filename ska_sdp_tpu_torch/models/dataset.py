"""Bank w-projection, fused AW, IDG and IDG-AW imaging and prediction in
memory (port of the programs of ``ska_sdp_tpu/models/dataset.py``), and
the PSF-normalised imaging of ``--mode simple``, ``conv`` and ``wcache``
(the reference CLI's branch).

Each path has an in-memory entry that takes a :class:`VisData` (defined in
``io.inputs``) and runs on a given device; ``models.runs`` holds the file
entries that read HDF5, call it and write HDF5:

  ==========================  ====================  =========================
  path                        in memory             file (``models.runs``)
  ==========================  ====================  =========================
  w-projection imaging        ``w_image``           ``w_gridding``
  fused AW imaging            ``aw_image``          ``aw_gridding``
  IDG imaging                 ``idg_image``         ``idg_gridding``
  IDG-AW imaging              ``aw_idg_image``      ``aw_gridding``
  w-projection predict        ``w_predict_vis``     ``w_predict``
  IDG predict                 ``idg_predict_vis``   ``idg_predict``
  IDG-AW predict              ``aw_predict_vis``    ``aw_predict``
  simple / conv / wcache      ``psf_image``         ``psf_gridding``
  w-projection, checkpointed  ``w_image_slabs``     ``w_gridding_checkpointed``
  w-projection, streamed      ``w_image_streamed``  ``w_gridding_out_of_core``
  ==========================  ====================  =========================

The imaging programs :func:`wproj_pipeline`, :func:`aw_pipeline`,
:func:`idg_pipeline` and :func:`aw_idg_pipeline` are the reference's
``_wproj_pipeline``, ``_aw_pipeline``, ``_idg_pipeline`` and
``_aw_idg_pipeline``:

    uvw → wavelengths → uniform weights → v ≥ 0 mirroring → gridder
        → Hermitian completion → centred inverse FFT
        [IDG: → ÷ fine taper → padded-FOV crop] → image max

where the bank and fused AW gridders pick each record's w-plane by
``find_closest`` on the mirrored w.  Each program is a prep stage
(:func:`weighted_mirrored`, under :func:`idg_grid_inputs`,
:func:`wproj_grid_inputs` and :func:`aw_grid_inputs`), a gridder and a
finish (:func:`idg_grid_image`, :func:`hermitian_image`); the staged
programs of ``models.runs`` time the same stages one by one.  The predict
programs (:func:`predict_pipeline`, :func:`idg_predict_pipeline`,
:func:`aw_idg_predict_pipeline`) walk back:

    model [IDG: → padded-FOV embedding → ÷ fine taper] → centred FFT
        → degridder at the records' unmirrored uvw in wavelengths

There is no PSF normalisation on these paths; ``psf_image`` runs
``models.imaging.do_imaging``, which divides the image and the PSF by the
PSF peak.

Long ``--mode w`` runs grid in slabs: ``w_image_slabs`` (every record in
memory, global uniform weights) and ``w_image_streamed`` (two streamed
passes over ``io.stream.SlabPrefetcher`` readers, the weights from a
histogram of the first) keep the running uv-grid on the device and hand
it to a callback after every slab.

Every caller array reaches the device through ``utils.hostmem.to_device``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..io.inputs import VisData
from ..io.stream import SlabPrefetcher
from ..kernels import (idg_aw_degridder, idg_aw_gridder, idg_degridder,
                       idg_gridder, note_drops, wproj_degridder,
                       wproj_gridder)
from ..ops import (doweight, fft_centered, ifft_centered, make_grid_hermitian,
                   mirror_uvw, uvw_lambda)
from ..ops.idg import (fov_pad_finish, fov_pad_geometry, fov_pad_start,
                       kaiser_taper, taper_fine)
from ..ops.idg_aw import aw_screens
from ..ops.search import find_closest
from ..types import SPEED_OF_LIGHT
from ..types import precision as _precision
from ..utils import hostmem
from ..utils.timing import PhaseTimer, readback, span
from .imaging import ImagingResult, aw_imaging, do_imaging, mode_imgfn


class IDGImage(NamedTuple):
    image: torch.Tensor    # [n, n] real, on the imaging device
    image_max: float
    n_dropped: int         # in-bounds records the gridder could not place


class WImage(NamedTuple):
    image: torch.Tensor    # [n, n] real, on the imaging device
    image_max: float


class Prediction(NamedTuple):
    vis: torch.Tensor      # [n] complex64 model visibilities, on the device
    peak: float            # max |vis|
    n_dropped: int         # in-bounds records the degridder could not place


AW_DROP_REASON = ("their uv spread exceeded their pair-chunk's subgrid; the "
                  "data is not track-ordered enough for IDG-AW")


# ---------------------------------------------------------------------------
# Inputs: the caller's arrays on the device
# ---------------------------------------------------------------------------


def _entry(name: str, vis_data: VisData, n: Optional[int], **counts):
    """The root span ``sdp.<name>`` of an in-memory entry over the first
    ``n`` records, with the entry's own ``counts`` beside ``records``,
    ``h2d_bytes`` and ``h2d_registered_bytes``."""
    return span(f"sdp.{name}", records=len(vis_data.uvw[:n]), h2d_bytes=0,
                h2d_registered_bytes=0, **counts)


def _uvw_freq(vis_data: VisData, n: Optional[int], prec, device):
    """``(uvw, f)`` tensors of the first ``n`` records on ``device``; the
    frequency's blocking copy first, so it waits for no copy of records."""
    f = hostmem.to_device(vis_data.frequency, device, dtype=prec.real)
    uvw = hostmem.to_device(vis_data.uvw[:n], device, np_dtype=prec.np_real)
    return uvw, f


def idg_inputs(vis_data: VisData, *, n: Optional[int] = None,
               precision: str = "single", device="cuda"):
    """``(uvw, f, vis)`` tensors of the first ``n`` records on ``device``."""
    prec = _precision(precision)
    uvw, f = _uvw_freq(vis_data, n, prec, device)
    vis = hostmem.to_device(vis_data.vis[:n], device,
                            np_dtype=prec.np_complex)
    return uvw, f, vis


def ant_ids(vis_data: VisData, n: int):
    """The first ``n`` records' antenna ids as int64 numpy, cast on the
    host (span ``sdp.host_prep.cast``) only where they are not."""
    ids = (vis_data.antenna1[:n], vis_data.antenna2[:n])
    if all(isinstance(a, np.ndarray) and a.dtype == np.int64 for a in ids):
        return ids
    with span("sdp.host_prep.cast", host_only=True):
        return tuple(np.asarray(a, np.int64) for a in ids)


def id_tensors(ids, device):
    """The antenna ids ``(a1, a2)`` as int32 tensors on ``device``."""
    return tuple(hostmem.to_device(a, device, np_dtype=np.int32)
                 for a in ids)


def stamp_tensors(akerns, prec, device) -> torch.Tensor:
    """The A-kernel stamps ``[nant, s, s]`` as ``prec.complex`` on
    ``device``."""
    if isinstance(akerns, torch.Tensor):
        return hostmem.to_device(akerns, device, dtype=prec.complex)
    return hostmem.to_device(akerns, device, np_dtype=prec.np_complex)


def bank_tensors(wkerns, wbins, prec, device):
    """``(bank, centres)`` tensors on ``device`` in the run's precision."""
    return (hostmem.to_device(wkerns, device, dtype=prec.complex),
            hostmem.to_device(wbins, device, dtype=prec.real))


def _model_tensor(model, theta: float, lam: int, prec, device):
    n_grid = int(round(theta * lam))
    if tuple(model.shape) != (n_grid, n_grid):
        raise ValueError(
            f"model image {tuple(model.shape)} does not match grid "
            f"({n_grid}, {n_grid}) for theta={theta}, lam={lam}")
    return hostmem.to_device(model, device, dtype=prec.real)


def aw_inputs(vis_data: VisData, wkerns, wbins, akerns, *,
              n: Optional[int], prec, device):
    """The fused AW imaging inputs of the first ``n`` records on
    ``device``: ``(bank, centres, stamps, uvw, f, vis, a1, a2)``."""
    bank, wb = bank_tensors(wkerns, wbins, prec, device)
    ak = stamp_tensors(akerns, prec, device)
    uvw, f, vis = idg_inputs(vis_data, n=n, precision=prec, device=device)
    a1, a2 = id_tensors(ant_ids(vis_data, vis.shape[0]), device)
    return bank, wb, ak, uvw, f, vis, a1, a2


def aw_idg_inputs(vis_data: VisData, akerns, *, n: int, prec, device):
    """The IDG-AW imaging inputs of the first ``n`` records on ``device``:
    ``(ids, stamps, uvw, f, vis, a1, a2)``, ``ids`` the host's int64 ids
    (:func:`ant_ids`) and ``a1``, ``a2`` their int32 tensors."""
    ids = ant_ids(vis_data, n)
    ak = stamp_tensors(akerns, prec, device)
    uvw, f, vis = idg_inputs(vis_data, n=n, precision=prec, device=device)
    return (ids, ak, uvw, f, vis) + id_tensors(ids, device)


def antenna_screens(akerns, subgrid: int, theta: float, lam: int, fov_pad,
                    prec, device) -> torch.Tensor:
    """Image-domain screens on ``device``, sampled at the gridding FOV's
    angular scale (``θ·n_grid/n`` with ``fov_pad``), built there from the
    stamps (numpy or a tensor) in complex128 and cast to
    ``prec.complex``."""
    n_t, n_g, _, _ = fov_pad_geometry(theta, lam, fov_pad)
    ak = stamp_tensors(akerns, prec, device)
    with span("sdp.device_prep"):
        return aw_screens(ak, subgrid, fov_scale=n_g / n_t,
                          dtype=prec.complex)


def pair_count(a1, a2) -> int:
    """The number of distinct ``(a1, a2)`` pairs, counted where the ids
    are (numpy ids on the CPU): the sorted pair keys' steps, read once."""
    a1, a2 = torch.as_tensor(a1), torch.as_tensor(a2)
    with span("sdp.device_prep"):
        keys = torch.sort(a1.to(torch.int64) * 2**32
                          + a2.to(torch.int64)).values
        npair = (keys[1:] != keys[:-1]).sum() + (keys.numel() > 0)
    return readback(npair, int)


def aw_run_bound(a1, a2, n: int) -> int:
    """IDG-AW ``max_runs``: each pair's track splits at a handful of
    coarse-uv-tile crossings, so ``8·npair + n/128 + 64`` bounds the runs
    of track data (:func:`pair_count`); overflow beyond it is counted, not
    refused."""
    return 8 * pair_count(a1, a2) + n // 128 + 64


def detect_time_major_layout(a1, a2, time, n):
    """Host-side check: are ``records[:n]`` an ``[ntime, nbl]`` raster (the
    vis-file layout, the same baseline set repeating per time slot)?
    Returns ``(ntime, nbl)`` if so, else None; None only costs the sort."""
    with span("sdp.host_prep.layout", host_only=True):
        t = np.asarray(time[:n])
        if n == 0:
            return None
        if t[0] == t[-1]:
            nbl = n
        else:
            nbl = int(np.argmax(t != t[0]))
            if nbl == 0 or n % nbl != 0:
                return None
        ntime = n // nbl
        a1r = np.asarray(a1[:n]).reshape(ntime, nbl)
        a2r = np.asarray(a2[:n]).reshape(ntime, nbl)
        tr = t.reshape(ntime, nbl)
        if not (np.all(a1r == a1r[0]) and np.all(a2r == a2r[0])
                and np.all(tr == tr[:, :1])):
            return None
        return ntime, nbl


def vis_chunk(n: int) -> int:
    """The reference's visibility chunk of the plain scatters and gather."""
    return min(8192, max(256, n))


# ---------------------------------------------------------------------------
# Program stages: prep and finish
# ---------------------------------------------------------------------------


class GridInputs(NamedTuple):
    grid_shape: tuple      # (n_grid, n_grid)
    p: torch.Tensor        # [n, 3] mirrored baselines scaled to ±0.5
    w: torch.Tensor        # [n] w in wavelengths
    vis: torch.Tensor      # [n] weighted, mirrored visibilities
    theta: float           # field of view of the (padded) grid
    n: int                 # target image size
    crop_lo: int


def weighted_mirrored(uvw, f, vis, *, theta: float, lam: int):
    """Every imaging program's prep: uvw in wavelengths, uniform weights
    on the target-FOV histogram of the unmirrored uvw, v ≥ 0 mirroring.
    Returns ``(mirrored uvw in wavelengths, weighted mirrored vis)``."""
    uvw0 = uvw_lambda(f, uvw)
    wt = doweight(theta, lam, uvw0, torch.ones_like(vis))
    uvw1, vis1 = mirror_uvw(uvw0, vis)
    return uvw1, wt * vis1


def idg_grid_inputs(uvw, f, vis, *, theta: float, lam: int,
                    fov_pad: Optional[float] = None) -> GridInputs:
    """The gridder's inputs: :func:`weighted_mirrored` (the weights on the
    target FOV regardless of ``fov_pad``) on the (padded) grid."""
    n, n_pad, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    uvw1, wvis = weighted_mirrored(uvw, f, vis, theta=theta, lam=lam)
    return GridInputs((n_pad, n_pad), uvw1 / lam, uvw1[:, 2], wvis,
                      theta_g, n, crop_lo)


def wproj_grid_inputs(uvw, f, vis, wbins, *, theta: float, lam: int):
    """The bank scatter's inputs: :func:`idg_grid_inputs` on the plain
    FOV and each record's w-plane closest to its mirrored w.  Returns
    ``(grid_shape, p, wbin, vis)``."""
    g = idg_grid_inputs(uvw, f, vis, theta=theta, lam=lam)
    return g.grid_shape, g.p, find_closest(wbins, g.w), g.vis


def aw_grid_inputs(uvw, a1, a2, f, vis, *, theta: float, lam: int,
                   fov_pad: Optional[float] = None, layout=None):
    """The IDG-AW gridder's inputs: :func:`idg_grid_inputs`, then, for a
    time-major raster ``layout=(ntime, nbl)`` (checked on the host by the
    caller), the transpose to pair-major that lets the prep skip its sort.
    Returns ``(GridInputs, a1, a2)``."""
    g = idg_grid_inputs(uvw, f, vis, theta=theta, lam=lam, fov_pad=fov_pad)
    if layout is None:
        return g, a1, a2
    ntime, nbl = layout

    def _pm(x):
        return (x.reshape((ntime, nbl) + x.shape[1:]).transpose(0, 1)
                .reshape((ntime * nbl,) + x.shape[1:]))

    return g._replace(p=_pm(g.p), w=_pm(g.w), vis=_pm(g.vis)), \
        _pm(a1), _pm(a2)


def idg_finish(guv: torch.Tensor, n: int, n_pad: int, crop_lo: int,
               subgrid: int, taper_beta: float, dtype=torch.float32):
    """Grid → image: Hermitian completion, centred inverse FFT, division
    by the fine taper, padded-FOV crop."""
    img = ifft_centered(make_grid_hermitian(guv)).real.to(dtype)
    tf = taper_fine(n_pad, subgrid,
                    kaiser_taper(subgrid, taper_beta, device=guv.device))
    tf = tf.to(img.dtype)
    img = img / (tf[:, None] * tf[None, :])
    return fov_pad_finish(img, n, n_pad, crop_lo)


def idg_grid_image(guv: torch.Tensor, g: GridInputs, subgrid: int,
                   taper_beta: float, dtype):
    """The IDG programs' finish on ``g``'s grid (:func:`idg_finish`):
    ``(img, img.max())``."""
    img = idg_finish(guv, g.n, g.grid_shape[0], g.crop_lo, subgrid,
                     taper_beta, dtype)
    return img, torch.max(img)


def hermitian_image(guv: torch.Tensor):
    """Hermitian completion and the centred inverse FFT: ``(img, max)``."""
    img = ifft_centered(make_grid_hermitian(guv)).real
    return img, torch.max(img)


# ---------------------------------------------------------------------------
# IDG and IDG-AW imaging
# ---------------------------------------------------------------------------


def idg_pipeline(uvw: torch.Tensor, f: torch.Tensor, vis: torch.Tensor, *,
                 theta: float, lam: int, subgrid: int, taper_beta: float,
                 fov_pad: Optional[float] = None):
    """The IDG imaging program on ``uvw``'s device.

    ``fov_pad`` (a fraction f ≤ 1, e.g. 0.75) grids a padded FOV θ/f at the
    same pixel size and crops the centre; ``None`` images the plain FOV,
    accurate inside ~75% of the image radius.  Returns ``(img, img.max(),
    n_dropped)`` as tensors.
    """
    with span("sdp.device_prep"):
        g = idg_grid_inputs(uvw, f, vis, theta=theta, lam=lam,
                            fov_pad=fov_pad)
    guv, n_dropped = idg_gridder(
        g.grid_shape, g.p, g.w, g.vis, theta=g.theta, subgrid=subgrid,
        taper_beta=taper_beta)
    with span("sdp.finish"):
        return idg_grid_image(guv, g, subgrid, taper_beta,
                              uvw.dtype) + (n_dropped,)


def idg_image(vis_data: VisData, *, theta: float = 0.008,
              lam: int = 300000, n: Optional[int] = None,
              subgrid: int = 64, taper_beta: float = 12.0,
              fov_pad: Optional[float] = None, precision: str = "single",
              device="cuda") -> IDGImage:
    """Image-domain-gridding dirty image of in-memory visibilities on
    ``device`` (``"cuda"`` runs the CUDA gridder, ``"cpu"`` its plain
    version): the streamed gridder where it serves the subgrid, the
    fixed-tile one elsewhere (S=32 with support 15 among them).  ``n``
    caps the record count.  Dropped records are counted in
    ``kernels.drop_counters()`` and warned about once."""
    with _entry("idg_image", vis_data, n):
        with span("sdp.host_prep"):
            uvw, f, vis = idg_inputs(vis_data, n=n, precision=precision,
                                     device=device)
        img, mx, n_dropped = idg_pipeline(
            uvw, f, vis, theta=theta, lam=lam, subgrid=subgrid,
            taper_beta=taper_beta, fov_pad=fov_pad)
        nd = readback(n_dropped, int)
        note_drops("idg_gridder", nd, "unfit records or run-table overflow")
        return IDGImage(img, readback(mx, float), nd)


def aw_idg_pipeline(screens, uvw, a1, a2, f, vis, *, theta: float,
                    lam: int, subgrid: int = 64, taper_beta: float = 12.0,
                    max_runs: int = 4096, fov_pad: Optional[float] = None,
                    layout=None):
    """The IDG-AW imaging program on ``uvw``'s device: image-domain
    A-screens ``[nant, S, S]`` on (pair, uv-tile) runs, continuous w.

    ``layout=(ntime, nbl)`` grids the time-major raster without a sort
    (:func:`aw_grid_inputs`); gridding is an order-invariant sum, so the
    image is unchanged.  Returns ``(img, img.max(), n_dropped)`` as
    tensors.
    """
    with span("sdp.device_prep"):
        g, a1, a2 = aw_grid_inputs(uvw, a1, a2, f, vis, theta=theta,
                                   lam=lam, fov_pad=fov_pad, layout=layout)
    guv, n_dropped = idg_aw_gridder(
        g.grid_shape, g.p, a1, a2, g.w, g.vis, screens, theta=g.theta,
        subgrid=subgrid, taper_beta=taper_beta, max_runs=max_runs,
        ordered=layout is not None)
    with span("sdp.finish"):
        return idg_grid_image(guv, g, subgrid, taper_beta,
                              uvw.dtype) + (n_dropped,)


def aw_idg_image(vis_data: VisData, akerns, *, theta: float = 0.008,
                 lam: int = 300000, n: Optional[int] = None,
                 subgrid: int = 64, taper_beta: float = 12.0,
                 fov_pad: Optional[float] = None, precision: str = "single",
                 device="cuda") -> IDGImage:
    """IDG-AW dirty image of in-memory visibilities with per-antenna
    A-kernels ``akerns`` ``[nant, s, s]`` on ``device``.  A time-major
    raster is detected on the host and gridded without a sort.  Dropped
    records are counted in ``kernels.drop_counters()`` and warned about
    once."""
    prec = _precision(precision)
    n = n if n is not None else vis_data.vis.shape[0]
    with _entry("aw_idg_image", vis_data, n):
        with span("sdp.host_prep"):
            (a1, a2), ak, uvw, f, vis, a1_d, a2_d = aw_idg_inputs(
                vis_data, akerns, n=n, prec=prec, device=device)
            layout = detect_time_major_layout(a1, a2, vis_data.time, n)
        max_runs = aw_run_bound(a1_d, a2_d, n)
        screens = antenna_screens(ak, subgrid, theta, lam, fov_pad, prec,
                                  device)
        img, mx, n_dropped = aw_idg_pipeline(
            screens, uvw, a1_d, a2_d, f, vis, theta=theta, lam=lam,
            subgrid=subgrid, taper_beta=taper_beta, max_runs=max_runs,
            fov_pad=fov_pad, layout=layout)
        nd = readback(n_dropped, int)
        note_drops("idg_aw_gridder", nd, AW_DROP_REASON)
        return IDGImage(img, readback(mx, float), nd)


# ---------------------------------------------------------------------------
# Prediction (degridding)
# ---------------------------------------------------------------------------


class DegridInputs(NamedTuple):
    grid: torch.Tensor     # [n_grid, n_grid] model uv-grid (÷ fine taper)
    p: torch.Tensor        # [n, 3] baselines scaled to ±0.5
    w: torch.Tensor        # [n] w in wavelengths
    theta: float           # field of view of the (padded) grid


def degrid_inputs(img: torch.Tensor, uvw, f, *, theta: float, lam: int,
                  subgrid: int, taper_beta: float,
                  fov_pad: Optional[float] = None) -> DegridInputs:
    """The degridders' inputs: the model embedded in the padded FOV,
    divided by the fine taper and transformed by the centred FFT, and the
    records' uvw in wavelengths."""
    uvw0 = uvw_lambda(f, uvw)
    n, n_grid, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    imgp = fov_pad_start(img, n, n_grid, crop_lo)
    tf = taper_fine(n_grid, subgrid,
                    kaiser_taper(subgrid, taper_beta, device=img.device))
    tf2 = (tf[:, None] * tf[None, :]).to(img.dtype)
    cdt = torch.complex64 if img.dtype == torch.float32 else torch.complex128
    return DegridInputs(fft_centered((imgp / tf2).to(cdt)), uvw0 / lam,
                        uvw0[:, 2], theta_g)


def idg_predict_pipeline(img, uvw, f, *, theta: float, lam: int,
                         subgrid: int, taper_beta: float,
                         fov_pad: Optional[float] = None):
    """Model image → IDG degridding (exact continuous-w prediction) on
    ``img``'s device.  ``fov_pad`` embeds the model in a padded FOV
    before the taper division, so edge sources carry the same bounded
    accuracy as the padded imaging direction.  Returns ``(vis,
    n_dropped)``."""
    with span("sdp.device_prep"):
        d = degrid_inputs(img, uvw, f, theta=theta, lam=lam,
                          subgrid=subgrid, taper_beta=taper_beta,
                          fov_pad=fov_pad)
    return idg_degridder(tuple(d.grid.shape), d.p, d.w, d.grid,
                         theta=d.theta, subgrid=subgrid,
                         taper_beta=taper_beta)


def aw_idg_predict_pipeline(screens, img, uvw, a1, a2, f, *, theta: float,
                            lam: int, subgrid: int, taper_beta: float,
                            max_runs: int, fov_pad: Optional[float] = None):
    """Model image → IDG-AW degridding: continuous-(u, v, w) prediction
    with direction-dependent antenna terms, the exact adjoint of the
    IDG-AW gridder.  ``screens`` must be sampled at the padded FOV's
    scale when ``fov_pad`` is set.  Returns ``(vis, n_dropped)``."""
    with span("sdp.device_prep"):
        d = degrid_inputs(img, uvw, f, theta=theta, lam=lam,
                          subgrid=subgrid, taper_beta=taper_beta,
                          fov_pad=fov_pad)
    return idg_aw_degridder(tuple(d.grid.shape), d.p, a1, a2, d.w, d.grid,
                            screens, theta=d.theta, subgrid=subgrid,
                            taper_beta=taper_beta, max_runs=max_runs)


def _prediction(vis: torch.Tensor, n_dropped, kind: str) -> Prediction:
    nd = readback(n_dropped, int)
    note_drops(kind, nd, "predictions are 0 there; the data is not "
               "track-ordered enough for pair-chunking")
    peak = readback(vis.abs().max(), float) if vis.numel() else 0.0
    return Prediction(vis, peak, nd)


def idg_predict_vis(vis_data: VisData, model, *, theta: float = 0.008,
                    lam: int = 300000, n: Optional[int] = None,
                    subgrid: int = 64, taper_beta: float = 12.0,
                    fov_pad: Optional[float] = None,
                    precision: str = "single", device="cuda") -> Prediction:
    """IDG prediction of the first ``n`` records' visibilities from the
    model image ``model`` ``[n_grid, n_grid]`` (numpy or tensor) on
    ``device`` (``"cuda"`` runs the CUDA degridder, ``"cpu"`` its plain
    version)."""
    prec = _precision(precision)
    with _entry("idg_predict_vis", vis_data, n):
        with span("sdp.host_prep"):
            img = _model_tensor(model, theta, lam, prec, device)
            uvw, f = _uvw_freq(vis_data, n, prec, device)
        vis, n_dropped = idg_predict_pipeline(
            img, uvw, f, theta=theta, lam=lam, subgrid=subgrid,
            taper_beta=taper_beta, fov_pad=fov_pad)
        return _prediction(vis, n_dropped, "idg_degridder")


def aw_predict_vis(vis_data: VisData, akerns, model, *,
                   theta: float = 0.008, lam: int = 300000,
                   n: Optional[int] = None, subgrid: int = 64,
                   taper_beta: float = 12.0, fov_pad: Optional[float] = None,
                   precision: str = "single", device="cuda") -> Prediction:
    """IDG-AW prediction with per-antenna A-kernels ``akerns`` ``[nant, s,
    s]`` from the model image on ``device``.  Dropped records predict 0
    and are counted in ``kernels.drop_counters()``."""
    prec = _precision(precision)
    n = n if n is not None else vis_data.uvw.shape[0]
    with _entry("aw_predict_vis", vis_data, n):
        with span("sdp.host_prep"):
            img = _model_tensor(model, theta, lam, prec, device)
            ids = ant_ids(vis_data, n)
            ak = stamp_tensors(akerns, prec, device)
            uvw, f = _uvw_freq(vis_data, n, prec, device)
            a1_d, a2_d = id_tensors(ids, device)
        max_runs = aw_run_bound(a1_d, a2_d, n)
        screens = antenna_screens(ak, subgrid, theta, lam, fov_pad, prec,
                                  device)
        vis, n_dropped = aw_idg_predict_pipeline(
            screens, img, uvw, a1_d, a2_d, f, theta=theta, lam=lam,
            subgrid=subgrid, taper_beta=taper_beta, max_runs=max_runs,
            fov_pad=fov_pad)
        return _prediction(vis, n_dropped, "idg_aw_degridder")


# ---------------------------------------------------------------------------
# Bank w-projection and fused AW-projection imaging, w-projection predict
# ---------------------------------------------------------------------------


def wproj_pipeline(bank_conj, wbins, uvw, f, vis, *, theta: float,
                   lam: int, chunk: int):
    """The w-projection imaging program on ``uvw``'s device: weights and
    mirroring as IDG's inputs, each record's w-plane closest to its
    mirrored w (:func:`wproj_grid_inputs`), the bank scatter, Hermitian
    completion and the centred inverse FFT.  Returns ``(img, img.max())``
    as tensors."""
    with span("sdp.device_prep"):
        shape, p, wbin, wvis = wproj_grid_inputs(uvw, f, vis, wbins,
                                                 theta=theta, lam=lam)
    guv = wproj_gridder(bank_conj, shape, p, wbin, wvis, chunk=chunk)
    with span("sdp.finish"):
        return hermitian_image(guv)


def w_image(vis_data: VisData, wkerns, wbins, *, theta: float = 0.008,
            lam: int = 300000, n: Optional[int] = None,
            precision: str = "single", device="cuda") -> WImage:
    """w-projection dirty image of in-memory visibilities through the
    unconjugated bank ``wkerns`` ``[nw, qpx, qpx, s, s]`` with plane
    centres ``wbins`` ``[nw]`` (numpy or tensors) on ``device``
    (``"cuda"`` runs the CUDA scatter, ``"cpu"`` its plain version).
    ``n`` caps the record count."""
    prec = _precision(precision)
    with _entry("w_image", vis_data, n):
        with span("sdp.host_prep"):
            uvw, f, vis = idg_inputs(vis_data, n=n, precision=precision,
                                     device=device)
            bank, wb = bank_tensors(wkerns, wbins, prec, device)
        img, mx = wproj_pipeline(torch.conj(bank).resolve_conj(), wb, uvw,
                                 f, vis, theta=theta, lam=lam,
                                 chunk=vis_chunk(vis.shape[0]))
        return WImage(img, readback(mx, float))


def aw_pipeline(wkerns, wbins, akerns, uvw, a1, a2, f, vis, *,
                theta: float, lam: int, chunk: int):
    """The fused AW imaging program on ``uvw``'s device: uniform weights
    on the unmirrored uvw in wavelengths, v ≥ 0 mirroring
    (:func:`weighted_mirrored`), the AW gridder (each record's w-plane
    closest to its mirrored w, A-kernels of its antennas), Hermitian
    completion and the centred inverse FFT.  Returns ``(img, img.max())``
    as tensors."""
    with span("sdp.device_prep"):
        uvw1, wvis = weighted_mirrored(uvw, f, vis, theta=theta, lam=lam)
    guv = aw_imaging(theta, lam, wkerns, wbins, akerns, uvw1, (a1, a2), wvis,
                     chunk=chunk)
    with span("sdp.finish"):
        return hermitian_image(guv)


def aw_image(vis_data: VisData, wkerns, wbins, akerns, *,
             theta: float = 0.008, lam: int = 300000,
             n: Optional[int] = None, precision: str = "single",
             device="cuda") -> WImage:
    """Fused AW-projection dirty image of in-memory visibilities through
    the unconjugated bank ``wkerns`` ``[nw, qpx, qpx, s, s]`` with plane
    centres ``wbins`` ``[nw]`` and the A-kernels ``akerns`` ``[nant, s,
    s]`` (numpy or tensors) on ``device`` (``"cuda"`` runs the CUDA fused
    gridder, ``"cpu"`` the plain scatter).  ``n`` caps the record count.
    The root span's ``aw_pairs`` and ``aw_table_bytes`` count the pair
    table the card's route builds (0 on the CPU, which builds none)."""
    prec = _precision(precision)
    with _entry("aw_image", vis_data, n, aw_pairs=0, aw_table_bytes=0):
        with span("sdp.host_prep"):
            bank, wb, ak, uvw, f, vis, a1, a2 = aw_inputs(
                vis_data, wkerns, wbins, akerns, n=n, prec=prec,
                device=device)
        img, mx = aw_pipeline(bank, wb, ak, uvw, a1, a2, f, vis,
                              theta=theta, lam=lam,
                              chunk=vis_chunk(vis.shape[0]))
        return WImage(img, readback(mx, float))


def predict_pipeline(wkerns, wbins, img, uvw, f, *, theta: float, lam: int,
                     chunk: int):
    """Model image → centred FFT → bank gather at the records' unmirrored
    uvw in wavelengths, each with the w-plane closest to its w."""
    with span("sdp.device_prep"):
        uvw0 = uvw_lambda(f, uvw)
        grid = fft_centered(img.to(wkerns.dtype))
        wbin = find_closest(wbins, uvw0[:, 2])
    return wproj_degridder(wkerns, grid, uvw0 / lam, wbin, chunk=chunk)


def w_predict_vis(vis_data: VisData, wkerns, wbins, model, *,
                  theta: float = 0.008, lam: int = 300000,
                  n: Optional[int] = None, precision: str = "single",
                  device="cuda") -> Prediction:
    """w-projection prediction of the first ``n`` records' visibilities
    from the model image ``[n_grid, n_grid]`` through the unconjugated bank
    on ``device`` (``"cuda"`` runs the CUDA gather, ``"cpu"`` its plain
    version).  Nothing is dropped on this path."""
    prec = _precision(precision)
    with _entry("w_predict_vis", vis_data, n):
        with span("sdp.host_prep"):
            img = _model_tensor(model, theta, lam, prec, device)
            uvw, f = _uvw_freq(vis_data, n, prec, device)
            bank, wb = bank_tensors(wkerns, wbins, prec, device)
        vis = predict_pipeline(bank, wb, img, uvw, f, theta=theta, lam=lam,
                               chunk=vis_chunk(uvw.shape[0]))
        return _prediction(vis, 0, "wproj_degridder")


# ---------------------------------------------------------------------------
# Slab-wise w-projection: every record in memory, or streamed
# ---------------------------------------------------------------------------


SlabCallback = Callable[[torch.Tensor, int], None]


def _start_grid(shape, grid, dtype, device) -> torch.Tensor:
    """The running uv-grid on ``device``: zeros, or a copy of ``grid``
    (numpy or tensor, e.g. a checkpoint's planes)."""
    if grid is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return hostmem.to_device(grid, device, dtype=dtype).clone()


def _grid_slab(bank_conj, wbins, uvw_l, wt, vis, grid, *, lam: int,
               chunk: int) -> torch.Tensor:
    """Grid one slab into the running uv-grid (the reference's
    ``_wgrid_slab``): v ≥ 0 mirroring, each record's w-plane closest to
    its mirrored w, weights ``wt`` on the mirrored visibilities, one bank
    scatter launch onto ``grid``.  ``uvw_l`` is in wavelengths."""
    uvw1, vis1 = mirror_uvw(uvw_l, vis)
    wbin = find_closest(wbins, uvw1[:, 2])
    return wproj_gridder(bank_conj, tuple(grid.shape), uvw1 / lam, wbin,
                         wt.to(vis.dtype) * vis1, chunk=chunk, init=grid)


def _slab_loop(slabs, grid, bank_conj, wbins, *, lam: int, chunk: int,
               timer: PhaseTimer, on_slab: Optional[SlabCallback],
               max_slabs: Optional[int], n: int):
    """Grid ``(s0, uvw_l, wt, vis)`` slabs into ``grid`` and hand the grid
    and the next record to ``on_slab`` after each.  Returns the grid, or
    None when ``max_slabs`` stopped the loop before the last record."""
    done = 0
    for s0, uvw_l, wt, vis in slabs:
        with timer.phase("grid/slab"):
            grid = _grid_slab(bank_conj, wbins, uvw_l, wt, vis, grid,
                              lam=lam, chunk=chunk)
        nxt = s0 + vis.shape[0]
        if on_slab is not None:
            with timer.phase("checkpoint/write"):
                on_slab(grid, nxt)
        done += 1
        if max_slabs is not None and done >= max_slabs and nxt < n:
            return None
    return grid


def _finish(grid: torch.Tensor, timer: PhaseTimer) -> WImage:
    with timer.phase("finish/fft"):
        img, mx = hermitian_image(grid)
        return WImage(img, float(mx))


def w_image_slabs(vis_data: VisData, wkerns, wbins, *, theta: float = 0.008,
                  lam: int = 300000, n: Optional[int] = None,
                  slab: int = 1 << 20, precision: str = "single",
                  device="cuda", start: int = 0, grid=None,
                  on_slab: Optional[SlabCallback] = None,
                  max_slabs: Optional[int] = None,
                  timer: Optional[PhaseTimer] = None) -> Optional[WImage]:
    """w-projection dirty image of in-memory visibilities gridded ``slab``
    records at a time from record ``start`` onto ``grid`` (zeros if None),
    the running grid kept on ``device``: one bank scatter launch a slab.

    The uniform weights are those of all ``n`` records, whatever the slab
    (the reference's ``w_gridding_checkpointed``).  After each slab
    ``on_slab(grid, next_record)`` receives the device grid (to copy it
    out; it must not modify it).  ``max_slabs`` stops after that many
    slabs and returns None if records remain (an interrupted run)."""
    timer = timer or PhaseTimer()
    prec = _precision(precision)
    uvw, f, vis = idg_inputs(vis_data, n=n, precision=prec, device=device)
    n = vis.shape[0]
    uvw_l = uvw_lambda(f, uvw)
    wt = doweight(theta, lam, uvw_l, torch.ones(n, dtype=prec.real,
                                                device=device))
    bank, wb = bank_tensors(wkerns, wbins, prec, device)
    n_grid = int(round(theta * lam))
    g = _start_grid((n_grid, n_grid), grid, prec.complex, device)
    slabs = ((s0, uvw_l[s0:s0 + slab], wt[s0:s0 + slab], vis[s0:s0 + slab])
             for s0 in range(start, n, slab))
    g = _slab_loop(slabs, g, torch.conj(bank).resolve_conj(), wb, lam=lam,
                   chunk=min(8192, slab), timer=timer, on_slab=on_slab,
                   max_slabs=max_slabs, n=n)
    return None if g is None else _finish(g, timer)


def _flat_cells(n_grid: int, p: torch.Tensor) -> torch.Tensor:
    """Flat int64 cell ``y·n + x`` of scaled baselines ``p`` at qpx=1, the
    coordinates formed in float64 (the reference's numpy ``frac_coord``:
    ``floor(n//2 + p·n + 0.5)``).  An x off the grid with y on it lands
    in a neighbouring row, as in the reference."""
    p = p.to(torch.float64)
    x = torch.floor(n_grid // 2 + p[:, 0] * n_grid + 0.5).to(torch.int64)
    y = torch.floor(n_grid // 2 + p[:, 1] * n_grid + 0.5).to(torch.int64)
    return y * n_grid + x


def _note_wait(timer: Optional[PhaseTimer], prefetcher) -> None:
    """Add a prefetcher's consumer wait to ``stream/prefetch-wait``."""
    if timer is not None:
        key = "stream/prefetch-wait"
        timer.times[key] = timer.times.get(key, 0.0) + prefetcher.wait_s


def stream_weight_counts(uvw_reader, n: int, frequency: float, *,
                         theta: float = 0.008, lam: int = 300000,
                         slab: int = 1 << 20, device="cuda",
                         timer: Optional[PhaseTimer] = None) -> torch.Tensor:
    """Pass 1 of the streamed run: the uniform-weighting occupancy
    histogram ``[n_grid²]`` int64 of the first ``n`` records that
    ``uvw_reader(start, count)`` returns (metres), counted on ``device``.
    Cells come from ``uvw·(f/c)`` in the reader's type (float64 for the
    vis file), scaled and rounded in float64; flat cells outside ``[0,
    n_grid²)`` are dropped and empty cells count 1 (the reference's
    ``w_gridding_out_of_core``, exactly)."""
    n_grid = int(round(theta * lam))
    size = n_grid * n_grid
    scale = frequency / SPEED_OF_LIGHT
    counts = torch.zeros((size,), dtype=torch.int64, device=device)
    reader = SlabPrefetcher({"uvw": uvw_reader}, n, slab)
    for _, sl in reader:
        uvw_l = hostmem.to_device(sl["uvw"], device) * scale
        flat = _flat_cells(n_grid, uvw_l / lam)
        inb = (flat >= 0) & (flat < size)
        # out-of-bounds cells add 0 at a clamped index: no host sync
        counts.index_add_(0, flat.clamp(0, size - 1), inb.to(torch.int64))
    _note_wait(timer, reader)
    counts[counts == 0] = 1
    return counts


def w_image_streamed(readers: dict, n: int, frequency: float, wkerns, wbins,
                     *, theta: float = 0.008, lam: int = 300000,
                     slab: int = 1 << 20, precision: str = "single",
                     device="cuda", start: int = 0, grid=None,
                     on_slab: Optional[SlabCallback] = None,
                     max_slabs: Optional[int] = None,
                     timer: Optional[PhaseTimer] = None) -> Optional[WImage]:
    """w-projection dirty image of ``n`` records streamed in two passes
    from ``readers`` (``{"uvw": ..., "vis": ...}``, each ``callable(start,
    count) -> ndarray``: uvw in metres, channel-0 visibilities) through
    ``io.stream.SlabPrefetcher``, the running grid kept on ``device``.

    Pass 1 (:func:`stream_weight_counts`) builds the weight histogram
    over all ``n`` records; pass 2 grids slabs from ``start``
    onto ``grid``, each record weighted by ``1/count`` of its cell looked
    up from ``uvw·(f/c)`` cast to the run's real type first and the flat
    cell clamped (the reference's ``w_gridding_out_of_core``, whose
    weights differ from :func:`w_image`'s).  ``on_slab`` and
    ``max_slabs`` as in :func:`w_image_slabs`.  The time spent waiting
    for slabs goes to ``timer.times["stream/prefetch-wait"]``."""
    timer = timer or PhaseTimer()
    prec = _precision(precision)
    n_grid = int(round(theta * lam))
    with timer.phase("weight/histogram"):
        counts = stream_weight_counts(readers["uvw"], n, frequency,
                                      theta=theta, lam=lam, slab=slab,
                                      device=device, timer=timer)
    bank, wb = bank_tensors(wkerns, wbins, prec, device)
    scale = frequency / SPEED_OF_LIGHT
    p2 = SlabPrefetcher(readers, n, slab, start=start)

    def slabs():
        for s0, sl in p2:
            uvw_l = (hostmem.to_device(sl["uvw"], device)
                     * scale).to(prec.real)
            flat = _flat_cells(n_grid, uvw_l / lam).clamp(0, n_grid ** 2 - 1)
            wt = (1.0 / counts[flat].to(torch.float64)).to(prec.real)
            vis = hostmem.to_device(sl["vis"], device,
                                    np_dtype=prec.np_complex)
            yield s0, uvw_l, wt, vis

    g = _start_grid((n_grid, n_grid), grid, prec.complex, device)
    try:
        g = _slab_loop(slabs(), g, torch.conj(bank).resolve_conj(), wb,
                       lam=lam, chunk=min(8192, slab), timer=timer,
                       on_slab=on_slab, max_slabs=max_slabs, n=n)
    finally:
        p2.close()
        _note_wait(timer, p2)
    return None if g is None else _finish(g, timer)


# ---------------------------------------------------------------------------
# PSF-normalised imaging: --mode simple, conv and wcache
# ---------------------------------------------------------------------------


def psf_image(vis_data: VisData, mode: str, *, theta: float = 0.008,
              lam: int = 300000, n: Optional[int] = None,
              wstep: float = 2000.0, w_range: Optional[tuple] = None,
              precision: str = "single", device="cuda") -> ImagingResult:
    """PSF-normalised dirty image of in-memory visibilities on ``device``
    through ``mode``'s imaging function (``models.imaging.mode_imgfn``:
    ``simple``, ``conv`` or ``wcache`` with bin width ``wstep`` and, where
    given, the fixed w range ``w_range`` ``(minw, maxw)``, which the other
    modes refuse with a ``ValueError``) and ``do_imaging``.  ``conv`` and
    ``wcache`` grid through the bank scatter (the CUDA kernel on
    ``"cuda"``, its plain version on ``"cpu"``); ``simple`` runs no
    hand-written kernel.  ``n`` caps the record count.  The root span's
    ``wkernel_planes`` and ``wkernel_bytes`` count the w-kernel planes
    synthesised in the call (``wcache`` builds its bank twice: for the
    image and for the PSF) and the bytes of the screens they were
    transformed from (``imaging.w_cache_imaging``)."""
    prec = _precision(precision)
    with _entry("psf_image", vis_data, n, wkernel_planes=0,
                wkernel_bytes=0):
        with span("sdp.host_prep"):
            uvw, f = _uvw_freq(vis_data, n, prec, device)
            m = uvw.shape[0]
            vis = hostmem.to_device(vis_data.vis[:m], device,
                                    np_dtype=prec.np_complex)
            a1, a2 = (hostmem.to_device(a, device)
                      for a in ant_ids(vis_data, m))
            t = hostmem.to_device(vis_data.time[:m], device,
                                  np_dtype=prec.np_real)
        with span("sdp.device_prep"):
            uvw0 = uvw_lambda(f, uvw)
        imgfn = mode_imgfn(mode, theta, uvw0, wstep, w_range)
        return do_imaging(theta, lam, uvw0, a1, a2, t, vis_data.frequency,
                          vis, imgfn)
