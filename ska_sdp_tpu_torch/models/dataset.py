"""Bank w-projection, fused AW, IDG and IDG-AW imaging and prediction
pipelines (port of the ``--mode w``, ``--mode aw [--idg]``, ``--mode idg``
and ``--mode predict [--idg [--aterms]]`` paths of
``ska_sdp_tpu/models/dataset.py``).

Each path has an in-memory entry that runs on a given device and a file
entry that reads HDF5, calls it and writes HDF5:

  ==========================  ====================  ==================
  path                        in memory             file
  ==========================  ====================  ==================
  w-projection imaging        ``w_image``           ``w_gridding``
  fused AW imaging            ``aw_image``          ``aw_gridding``
  IDG imaging                 ``idg_image``         ``idg_gridding``
  IDG-AW imaging              ``aw_idg_image``      ``aw_gridding``
  w-projection predict        ``w_predict_vis``     ``w_predict``
  IDG predict                 ``idg_predict_vis``   ``idg_predict``
  IDG-AW predict              ``aw_predict_vis``    ``aw_predict``
  ==========================  ====================  ==================

The imaging programs are the reference's ``_wproj_pipeline``,
``_aw_pipeline``, ``_idg_pipeline`` and ``_aw_idg_pipeline``:

    uvw → wavelengths → uniform weights → v ≥ 0 mirroring → gridder
        → Hermitian completion → centred inverse FFT
        [IDG: → ÷ fine taper → padded-FOV crop] → image max

where the bank and fused AW gridders pick each record's w-plane by
``find_closest`` on the mirrored w.  The predict programs
(``_predict_pipeline``, ``_idg_predict_pipeline``,
``_aw_idg_predict_pipeline``) walk back:

    model [IDG: → padded-FOV embedding → ÷ fine taper] → centred FFT
        → degridder at the records' unmirrored uvw in wavelengths

There is no PSF normalisation on these paths.  ``idg_gridding(...,
device_phases=True)`` runs the IDG program as separately synchronised,
timed stages (``_idg_staged``, the reference's ``--device-phases``).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ImagingConfig
from ..io import h5, schema
from ..kernels import (_note_drops, idg_aw_degridder, idg_aw_gridder,
                       idg_degridder, idg_gridder, wproj_degridder,
                       wproj_gridder)
from ..kernels.idg_tile import idg_bin_records, idg_grid_from_records
from ..ops import (doweight, fft_centered, ifft_centered, make_grid_hermitian,
                   mirror_uvw, uvw_lambda)
from ..ops.idg import (fov_pad_finish, fov_pad_geometry, fov_pad_start,
                       kaiser_taper, taper_fine)
from ..ops.idg_aw import aw_screens_host
from ..ops.search import find_closest
from ..types import precision as _precision
from ..utils.timing import PhaseTimer
from .imaging import aw_imaging


class VisData(NamedTuple):
    vis: np.ndarray        # [n] complex — channel 0
    uvw: np.ndarray        # [n, 3] float (metres)
    antenna1: np.ndarray   # [n] int64
    antenna2: np.ndarray   # [n] int64
    time: np.ndarray       # [n] float
    frequency: float       # channel 0 (Hz)
    vis_chan: np.ndarray = None    # [n, nch] complex — all channels
    frequencies: np.ndarray = None  # [nch] float64 (Hz)


class IDGImage(NamedTuple):
    image: torch.Tensor    # [n, n] real, on the imaging device
    image_max: float
    n_dropped: int         # in-bounds records the gridder could not place


class Prediction(NamedTuple):
    vis: torch.Tensor      # [n] complex64 model visibilities, on the device
    peak: float            # max |vis|
    n_dropped: int         # in-bounds records the degridder could not place


def vis_data_from_observation(obs: dict) -> VisData:
    """:class:`VisData` from ``io.synthetic.simulate_observation``'s dict,
    exactly as :func:`load_vis_data` would read it back from a file."""
    freqs = np.asarray(obs["frequency"], np.float64).reshape(-1)
    vis_chan = np.asarray(obs["vis"], np.complex128).reshape(
        -1, freqs.shape[0])
    return VisData(vis_chan[:, 0], np.asarray(obs["uvw"], np.float64),
                   np.asarray(obs["antenna1"], np.int64),
                   np.asarray(obs["antenna2"], np.int64),
                   np.asarray(obs["time"], np.float64), float(freqs[0]),
                   vis_chan, freqs)


def _require_file(path: str) -> None:
    p = h5.fix_ext(path)
    if not os.path.exists(p):
        raise FileNotFoundError(f"input HDF5 file does not exist: {p}")


def load_vis_data(datfile: str) -> VisData:
    """Read the ``/vis`` tree.  The trailing axis of ``/vis/vis`` is the
    channel; ``vis``/``frequency`` keep channel 0 (the reference
    semantics), ``vis_chan``/``frequencies`` hold every channel."""
    _require_file(datfile)
    raw = h5.read_dataset(datfile, schema.VIS_VIS, dtype=np.complex128)
    uvw = h5.read_dataset(datfile, schema.VIS_UVW, dtype=np.float64)
    a1 = h5.read_dataset(datfile, schema.VIS_ANTENNA1, dtype=np.int64)
    a2 = h5.read_dataset(datfile, schema.VIS_ANTENNA2, dtype=np.int64)
    t = h5.read_dataset(datfile, schema.VIS_TIME, dtype=np.float64)
    f = h5.read_dataset(datfile, schema.VIS_FREQUENCY,
                        dtype=np.float64).reshape(-1)
    nch = f.shape[0]
    if nch > 1 and raw.ndim >= 1 and raw.shape[-1] == nch:
        vis_chan = raw.reshape(-1, nch)
    else:
        vis_chan = raw.reshape(-1, 1)
    return VisData(vis_chan[:, 0], uvw, a1, a2, t, float(f[0]),
                   vis_chan, f[:vis_chan.shape[1]])


def _idg_pipeline(uvw: torch.Tensor, f: torch.Tensor, vis: torch.Tensor, *,
                  theta: float, lam: int, subgrid: int, taper_beta: float,
                  fov_pad: Optional[float] = None):
    """The IDG imaging program on ``uvw``'s device.

    ``fov_pad`` (a fraction f ≤ 1, e.g. 0.75) grids a padded FOV θ/f at the
    same pixel size and crops the centre; ``None`` images the plain FOV,
    accurate inside ~75% of the image radius.  Returns ``(img, img.max(),
    n_dropped)`` as tensors.
    """
    g = idg_grid_inputs(uvw, f, vis, theta=theta, lam=lam, fov_pad=fov_pad)
    guv, n_dropped = idg_gridder(
        g.grid_shape, g.p, g.w, g.vis, theta=g.theta, subgrid=subgrid,
        taper_beta=taper_beta)
    img = _idg_finish(guv, g.n, g.grid_shape[0], g.crop_lo, subgrid,
                      taper_beta, uvw.dtype)
    return img, torch.max(img), n_dropped


class GridInputs(NamedTuple):
    grid_shape: tuple      # (n_grid, n_grid)
    p: torch.Tensor        # [n, 3] mirrored baselines scaled to ±0.5
    w: torch.Tensor        # [n] w in wavelengths
    vis: torch.Tensor      # [n] weighted, mirrored visibilities
    theta: float           # field of view of the (padded) grid
    n: int                 # target image size
    crop_lo: int


def idg_grid_inputs(uvw, f, vis, *, theta: float, lam: int,
                    fov_pad: Optional[float] = None) -> GridInputs:
    """The gridder's inputs: uvw in wavelengths, uniform weights on the
    target-FOV histogram (regardless of ``fov_pad``), v ≥ 0 mirroring."""
    uvw0 = uvw_lambda(f, uvw)
    n, n_pad, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    wt = doweight(theta, lam, uvw0, torch.ones_like(vis))
    uvw1, vis1 = mirror_uvw(uvw0, vis)
    return GridInputs((n_pad, n_pad), uvw1 / lam, uvw1[:, 2], wt * vis1,
                      theta_g, n, crop_lo)


def _idg_finish(guv: torch.Tensor, n: int, n_pad: int, crop_lo: int,
                subgrid: int, taper_beta: float, dtype=torch.float32):
    """Grid → image: Hermitian completion, centred inverse FFT, division
    by the fine taper, padded-FOV crop."""
    img = ifft_centered(make_grid_hermitian(guv)).real.to(dtype)
    tf = taper_fine(n_pad, subgrid,
                    kaiser_taper(subgrid, taper_beta, device=guv.device))
    tf = tf.to(img.dtype)
    img = img / (tf[:, None] * tf[None, :])
    return fov_pad_finish(img, n, n_pad, crop_lo)


def _uvw_freq(vis_data: VisData, n: Optional[int], prec, device):
    """``(uvw, f)`` tensors of the first ``n`` records on ``device``."""
    uvw = torch.as_tensor(np.asarray(vis_data.uvw[:n], prec.np_real),
                          device=device)
    f = torch.tensor(vis_data.frequency, dtype=prec.real, device=device)
    return uvw, f


def idg_inputs(vis_data: VisData, *, n: Optional[int] = None,
               precision: str = "single", device="cuda"):
    """``(uvw, f, vis)`` tensors of the first ``n`` records on ``device``."""
    prec = _precision(precision)
    uvw, f = _uvw_freq(vis_data, n, prec, device)
    vis = torch.as_tensor(np.asarray(vis_data.vis[:n], prec.np_complex),
                          device=device)
    return uvw, f, vis


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
    uvw, f, vis = idg_inputs(vis_data, n=n, precision=precision,
                             device=device)
    img, mx, n_dropped = _idg_pipeline(
        uvw, f, vis, theta=theta, lam=lam, subgrid=subgrid,
        taper_beta=taper_beta, fov_pad=fov_pad)
    nd = int(n_dropped)
    _note_drops("idg_gridder", nd, "unfit records or run-table overflow")
    return IDGImage(img, float(mx), nd)


def _idg_staged(uvw: torch.Tensor, f: torch.Tensor, vis: torch.Tensor, *,
                theta: float, lam: int, subgrid: int, taper_beta: float,
                timer: PhaseTimer, fov_pad: Optional[float] = None):
    """The IDG imaging program on ``uvw``'s device as four separately
    synchronised stages, timed by ``timer.device_stage``: ``preprocess``
    (wavelengths, weights, mirroring), ``bin+sort`` (the fixed-tile prep),
    ``idg-kernel+fold`` (the fixed-tile gridder) and
    ``hermitian+ifft+taper``; ``fov_pad`` as in :func:`_idg_pipeline`.
    Every stage runs twice (warm-up, then timed).  Returns ``(img,
    image max)``."""
    n, n_grid, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    shape = (n_grid, n_grid)
    timer.dispatch_floor(uvw.device)

    def prep(uvw, f, vis):
        g = idg_grid_inputs(uvw, f, vis, theta=theta, lam=lam,
                            fov_pad=fov_pad)
        return g.p, g.w, g.vis

    p, w, vis1 = timer.device_stage("preprocess", prep, uvw, f, vis)
    recs, starts = timer.device_stage(
        "bin+sort", idg_bin_records, shape, p, w, vis1.real, vis1.imag,
        subgrid=subgrid)
    guv = timer.device_stage(
        "idg-kernel+fold", idg_grid_from_records, recs, starts, shape,
        theta=theta_g, subgrid=subgrid, taper_beta=taper_beta)

    def image(guv):
        img = _idg_finish(guv, n, n_grid, crop_lo, subgrid, taper_beta,
                          uvw.dtype)
        return img, torch.max(img)

    img, mx = timer.device_stage("hermitian+ifft+taper", image, guv)
    return img, float(mx)


def idg_gridding(datfile: str, n: Optional[int] = None,
                 outfile: Optional[str] = None,
                 config: ImagingConfig = ImagingConfig(),
                 timer: Optional[PhaseTimer] = None,
                 subgrid: int = 64, taper_beta: float = 12.0,
                 fov_pad: Optional[float] = None,
                 device_phases: bool = False, device="cuda"):
    """IDG imaging run from an HDF5 file: load ``/vis``, image on
    ``device``, optionally write ``/img`` (float64).  ``device_phases``
    runs the stage-synchronised :func:`_idg_staged` (through the
    fixed-tile kernels, whatever the subgrid) and records its stage times
    in ``timer``.  Returns ``(image max, image as numpy)``."""
    timer = timer or PhaseTimer()
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    if device_phases:
        uvw, f, vis = idg_inputs(data, n=n, precision=config.precision_name,
                                 device=device)
        img_t, mx = _idg_staged(uvw, f, vis, theta=config.grid.theta,
                                lam=config.grid.lam, subgrid=subgrid,
                                taper_beta=taper_beta, timer=timer,
                                fov_pad=fov_pad)
        img = img_t.cpu().numpy()
    else:
        with timer.phase("h2d+compile+grid+fft"):
            res = idg_image(data, theta=config.grid.theta,
                            lam=config.grid.lam, n=n, subgrid=subgrid,
                            taper_beta=taper_beta, fov_pad=fov_pad,
                            precision=config.precision_name, device=device)
            img, mx = res.image.cpu().numpy(), res.image_max
    if outfile is not None:
        with timer.phase("write/img"):
            h5.create_file(outfile)
            h5.write_dataset(outfile, schema.IMG_DATASET,
                             img.astype(np.float64))
    return mx, img


# ---------------------------------------------------------------------------
# A-kernel ingest
# ---------------------------------------------------------------------------


def _closest(sorted_pairs, x: float) -> str:
    vals = [v for v, _ in sorted_pairs]
    idx = int(np.argmin([abs(v - x) for v in vals]))
    return sorted_pairs[idx][1]


def get_akernels(afile: str, theta: float, t: float, f: float) -> np.ndarray:
    """Per-antenna A-kernels at the closest time and frequency, stacked as
    ``[nant, s, s]`` complex128.  The closest frequency is searched in the
    frequency list (the reference's fix of the original, which searched
    the time list)."""
    _require_file(afile)
    grp = schema.akern_group(theta)
    ants = schema.parse_sorted(h5.list_group(afile, grp))
    a0 = ants[0][1]
    times = schema.parse_sorted(h5.list_group(afile, f"{grp}/{a0}"))
    closest_t = _closest(times, t)
    freqs = schema.parse_sorted(
        h5.list_group(afile, f"{grp}/{a0}/{closest_t}"))
    closest_f = _closest(freqs, f)
    names = [schema.akern_dataset(theta, ant, closest_t, closest_f)
             for _, ant in ants]
    return h5.read_datasets_stacked(afile, names, dtype=np.complex128)


def _aw_run_bound(a1: np.ndarray, a2: np.ndarray, n: int) -> int:
    """IDG-AW ``max_runs``: each pair's track splits at a handful of
    coarse-uv-tile crossings, so ``8·npair + n/128 + 64`` bounds the runs
    of track data; overflow beyond it is counted, not refused."""
    nant_b = int(max(a1.max(initial=0), a2.max(initial=0))) + 2
    npair = len(np.unique(a1 * nant_b + a2))
    return 8 * npair + n // 128 + 64


def _aw_screens(akerns, subgrid: int, theta: float, lam: int, fov_pad,
                prec, device) -> torch.Tensor:
    """Image-domain screens on ``device``, sampled at the gridding FOV's
    angular scale (``θ·n_grid/n`` with ``fov_pad``)."""
    n_t, n_g, _, _ = fov_pad_geometry(theta, lam, fov_pad)
    scr = aw_screens_host(np.asarray(akerns, prec.np_complex), subgrid,
                          fov_scale=n_g / n_t).astype(prec.np_complex)
    return torch.as_tensor(scr, device=device)


def _ant_ids(vis_data: VisData, n: int):
    return (np.asarray(vis_data.antenna1[:n], np.int64),
            np.asarray(vis_data.antenna2[:n], np.int64))


# ---------------------------------------------------------------------------
# IDG-AW imaging
# ---------------------------------------------------------------------------


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


def _aw_idg_pipeline(screens, uvw, a1, a2, f, vis, *, theta: float,
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
    g, a1, a2 = aw_grid_inputs(uvw, a1, a2, f, vis, theta=theta, lam=lam,
                               fov_pad=fov_pad, layout=layout)
    guv, n_dropped = idg_aw_gridder(
        g.grid_shape, g.p, a1, a2, g.w, g.vis, screens, theta=g.theta,
        subgrid=subgrid, taper_beta=taper_beta, max_runs=max_runs,
        ordered=layout is not None)
    img = _idg_finish(guv, g.n, g.grid_shape[0], g.crop_lo, subgrid,
                      taper_beta, uvw.dtype)
    return img, torch.max(img), n_dropped


def _detect_time_major_layout(a1, a2, time, n):
    """Host-side check: are ``records[:n]`` an ``[ntime, nbl]`` raster (the
    vis-file layout, the same baseline set repeating per time slot)?
    Returns ``(ntime, nbl)`` if so, else None; None only costs the sort."""
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
    a1, a2 = _ant_ids(vis_data, n)
    screens = _aw_screens(akerns, subgrid, theta, lam, fov_pad, prec, device)
    uvw, f, vis = idg_inputs(vis_data, n=n, precision=precision,
                             device=device)
    img, mx, n_dropped = _aw_idg_pipeline(
        screens, uvw, torch.as_tensor(a1.astype(np.int32), device=device),
        torch.as_tensor(a2.astype(np.int32), device=device), f, vis,
        theta=theta, lam=lam, subgrid=subgrid, taper_beta=taper_beta,
        max_runs=_aw_run_bound(a1, a2, n), fov_pad=fov_pad,
        layout=_detect_time_major_layout(a1, a2, vis_data.time, n))
    nd = int(n_dropped)
    _note_drops("idg_aw_gridder", nd,
                "their uv spread exceeded their pair-chunk's subgrid; the "
                "data is not track-ordered enough for IDG-AW")
    return IDGImage(img, float(mx), nd)


def aw_gridding(wfile: Optional[str], afile: str, datfile: str,
                n: Optional[int] = None, outfile: Optional[str] = None,
                config: ImagingConfig = ImagingConfig(),
                idg: bool = False, fov_pad: Optional[float] = None,
                subgrid: int = 64, device_phases: bool = False,
                device="cuda"):
    """AW imaging run from HDF5 files, the reference's argument order.
    ``idg=False`` is fused AW-projection (:func:`aw_image`: the ``wfile``
    bank, A-kernels from ``afile`` at the data's first time and its
    frequency).  ``idg=True`` is IDG-AW
    (:func:`aw_idg_image`, screens from the same A-kernels; ``wfile`` may
    be None).
    ``device_phases`` raises ``NotImplementedError``.  Returns ``(image
    max, image as numpy)`` and optionally writes ``/img``."""
    if device_phases:
        raise NotImplementedError(
            "device_phases (staged device timings) is not ported yet")
    data = load_vis_data(datfile)
    akerns = get_akernels(afile, config.grid.theta, float(data.time[0]),
                          data.frequency)
    if idg:
        res = aw_idg_image(data, akerns, theta=config.grid.theta,
                           lam=config.grid.lam, n=n, subgrid=subgrid,
                           fov_pad=fov_pad, precision=config.precision_name,
                           device=device)
    else:
        if wfile is None:
            raise ValueError("fused AW imaging needs a w-kernel file")
        wkerns, wbins = get_wkernels(wfile, config.grid.theta)
        res = aw_image(data, wkerns, wbins, akerns, theta=config.grid.theta,
                       lam=config.grid.lam, n=n,
                       precision=config.precision_name, device=device)
    img = res.image.cpu().numpy()
    if outfile is not None:
        h5.create_file(outfile)
        h5.write_dataset(outfile, schema.IMG_DATASET, img.astype(np.float64))
    return res.image_max, img


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


def _idg_predict_pipeline(img, uvw, f, *, theta: float, lam: int,
                          subgrid: int, taper_beta: float,
                          fov_pad: Optional[float] = None):
    """Model image → IDG degridding (exact continuous-w prediction) on
    ``img``'s device.  ``fov_pad`` embeds the model in a padded FOV
    before the taper division, so edge sources carry the same bounded
    accuracy as the padded imaging direction.  Returns ``(vis,
    n_dropped)``."""
    d = degrid_inputs(img, uvw, f, theta=theta, lam=lam, subgrid=subgrid,
                      taper_beta=taper_beta, fov_pad=fov_pad)
    return idg_degridder(tuple(d.grid.shape), d.p, d.w, d.grid,
                         theta=d.theta, subgrid=subgrid,
                         taper_beta=taper_beta)


def _aw_idg_predict_pipeline(screens, img, uvw, a1, a2, f, *, theta: float,
                             lam: int, subgrid: int, taper_beta: float,
                             max_runs: int, fov_pad: Optional[float] = None):
    """Model image → IDG-AW degridding: continuous-(u, v, w) prediction
    with direction-dependent antenna terms, the exact adjoint of the
    IDG-AW gridder.  ``screens`` must be sampled at the padded FOV's
    scale when ``fov_pad`` is set.  Returns ``(vis, n_dropped)``."""
    d = degrid_inputs(img, uvw, f, theta=theta, lam=lam, subgrid=subgrid,
                      taper_beta=taper_beta, fov_pad=fov_pad)
    return idg_aw_degridder(tuple(d.grid.shape), d.p, a1, a2, d.w, d.grid,
                            screens, theta=d.theta, subgrid=subgrid,
                            taper_beta=taper_beta, max_runs=max_runs)


def _model_tensor(model, theta: float, lam: int, prec, device):
    n_grid = int(round(theta * lam))
    if tuple(model.shape) != (n_grid, n_grid):
        raise ValueError(
            f"model image {tuple(model.shape)} does not match grid "
            f"({n_grid}, {n_grid}) for theta={theta}, lam={lam}")
    return torch.as_tensor(model, dtype=prec.real, device=device)


def _prediction(vis: torch.Tensor, n_dropped, kind: str) -> Prediction:
    nd = int(n_dropped)
    _note_drops(kind, nd, "predictions are 0 there; the data is not "
                "track-ordered enough for pair-chunking")
    peak = float(vis.abs().max()) if vis.numel() else 0.0
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
    img = _model_tensor(model, theta, lam, prec, device)
    uvw, f = _uvw_freq(vis_data, n, prec, device)
    vis, n_dropped = _idg_predict_pipeline(
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
    img = _model_tensor(model, theta, lam, prec, device)
    n = n if n is not None else vis_data.uvw.shape[0]
    a1, a2 = _ant_ids(vis_data, n)
    screens = _aw_screens(akerns, subgrid, theta, lam, fov_pad, prec, device)
    uvw, f = _uvw_freq(vis_data, n, prec, device)
    vis, n_dropped = _aw_idg_predict_pipeline(
        screens, img, uvw,
        torch.as_tensor(a1.astype(np.int32), device=device),
        torch.as_tensor(a2.astype(np.int32), device=device), f,
        theta=theta, lam=lam, subgrid=subgrid, taper_beta=taper_beta,
        max_runs=_aw_run_bound(a1, a2, n), fov_pad=fov_pad)
    return _prediction(vis, n_dropped, "idg_aw_degridder")


def _write_prediction(outfile: Optional[str], pred: np.ndarray) -> None:
    if outfile is not None:
        h5.create_file(outfile)
        h5.write_dataset(outfile, schema.MODEL_VIS_DATASET,
                         pred.astype(np.complex128))


def idg_predict(datfile: str, modelfile: str, n: Optional[int] = None,
                outfile: Optional[str] = None,
                config: ImagingConfig = ImagingConfig(), subgrid: int = 32,
                taper_beta: float = 12.0, fov_pad: Optional[float] = None,
                device="cuda"):
    """IDG prediction run from HDF5 files: ``/vis`` records and the
    ``/img`` model in, ``/vis/model`` out.  The default ``subgrid=32`` is
    the reference's; with support 15 it runs on the fixed-tile degridder.
    Returns ``(predicted ndarray, peak |vis|)``."""
    data = load_vis_data(datfile)
    img = h5.read_dataset(modelfile, schema.IMG_DATASET)
    res = idg_predict_vis(data, img, theta=config.grid.theta,
                          lam=config.grid.lam, n=n, subgrid=subgrid,
                          taper_beta=taper_beta, fov_pad=fov_pad,
                          precision=config.precision_name, device=device)
    pred = res.vis.cpu().numpy()
    _write_prediction(outfile, pred)
    return pred, res.peak


def aw_predict(afile: str, datfile: str, modelfile: str,
               n: Optional[int] = None, outfile: Optional[str] = None,
               config: ImagingConfig = ImagingConfig(), subgrid: int = 64,
               taper_beta: float = 12.0, fov_pad: Optional[float] = None,
               device="cuda"):
    """IDG-AW prediction run from HDF5 files (screens from the akern file
    at the data's first time and its frequency).  Returns ``(predicted
    ndarray, peak |vis|)`` and optionally writes ``/vis/model``."""
    data = load_vis_data(datfile)
    akerns = get_akernels(afile, config.grid.theta, float(data.time[0]),
                          data.frequency)
    img = h5.read_dataset(modelfile, schema.IMG_DATASET)
    res = aw_predict_vis(data, akerns, img, theta=config.grid.theta,
                         lam=config.grid.lam, n=n, subgrid=subgrid,
                         taper_beta=taper_beta, fov_pad=fov_pad,
                         precision=config.precision_name, device=device)
    pred = res.vis.cpu().numpy()
    _write_prediction(outfile, pred)
    return pred, res.peak


# ---------------------------------------------------------------------------
# Bank w-projection imaging and prediction
# ---------------------------------------------------------------------------


class WImage(NamedTuple):
    image: torch.Tensor    # [n, n] real, on the imaging device
    image_max: float


def get_wkernels(wfile: str, theta: float):
    """The w-kernel bank sorted by plane centre: ``([nw, qpx, qpx, s, s]
    complex128 unconjugated, [nw] float64 centres)``."""
    _require_file(wfile)
    wbins = schema.parse_sorted(h5.list_group(wfile,
                                              schema.wkern_group(theta)))
    names = [schema.wkern_dataset(theta, name) for _, name in wbins]
    bank = h5.read_datasets_stacked(wfile, names, dtype=np.complex128)
    return bank, np.array([v for v, _ in wbins], dtype=np.float64)


def _vis_chunk(n: int) -> int:
    """The reference's visibility chunk of the plain scatters and gather."""
    return min(8192, max(256, n))


def _wproj_pipeline(bank_conj, wbins, uvw, f, vis, *, theta: float,
                    lam: int, chunk: int):
    """The w-projection imaging program on ``uvw``'s device: weights and
    mirroring as IDG's inputs, each record's w-plane closest to its
    mirrored w, the bank scatter, Hermitian completion and the centred
    inverse FFT.  Returns ``(img, img.max())`` as tensors."""
    g = idg_grid_inputs(uvw, f, vis, theta=theta, lam=lam)
    wbin = find_closest(wbins, g.w)
    guv = wproj_gridder(bank_conj, g.grid_shape, g.p, wbin, g.vis,
                        chunk=chunk)
    img = ifft_centered(make_grid_hermitian(guv)).real
    return img, torch.max(img)


def _bank(wkerns, wbins, prec, device):
    """``(bank, centres)`` tensors on ``device`` in the run's precision."""
    return (torch.as_tensor(wkerns, dtype=prec.complex, device=device),
            torch.as_tensor(wbins, dtype=prec.real, device=device))


def w_image(vis_data: VisData, wkerns, wbins, *, theta: float = 0.008,
            lam: int = 300000, n: Optional[int] = None,
            precision: str = "single", device="cuda") -> WImage:
    """w-projection dirty image of in-memory visibilities through the
    unconjugated bank ``wkerns`` ``[nw, qpx, qpx, s, s]`` with plane
    centres ``wbins`` ``[nw]`` (numpy or tensors) on ``device``
    (``"cuda"`` runs the CUDA scatter, ``"cpu"`` its plain version).
    ``n`` caps the record count."""
    prec = _precision(precision)
    uvw, f, vis = idg_inputs(vis_data, n=n, precision=precision,
                             device=device)
    bank, wb = _bank(wkerns, wbins, prec, device)
    img, mx = _wproj_pipeline(torch.conj(bank).resolve_conj(), wb, uvw, f,
                              vis, theta=theta, lam=lam,
                              chunk=_vis_chunk(vis.shape[0]))
    return WImage(img, float(mx))


def w_gridding(wfile: str, datfile: str, n: Optional[int] = None,
               outfile: Optional[str] = None,
               config: ImagingConfig = ImagingConfig(), device="cuda"):
    """w-projection imaging run from HDF5 files: ``/vis`` and the
    ``/wkern`` bank in, optionally ``/img`` (float64) out.  Returns
    ``(image max, image as numpy)``."""
    data = load_vis_data(datfile)
    wkerns, wbins = get_wkernels(wfile, config.grid.theta)
    res = w_image(data, wkerns, wbins, theta=config.grid.theta,
                  lam=config.grid.lam, n=n, precision=config.precision_name,
                  device=device)
    img = res.image.cpu().numpy()
    if outfile is not None:
        h5.create_file(outfile)
        h5.write_dataset(outfile, schema.IMG_DATASET, img.astype(np.float64))
    return res.image_max, img


# ---------------------------------------------------------------------------
# Fused AW-projection imaging
# ---------------------------------------------------------------------------


def _aw_pipeline(wkerns, wbins, akerns, uvw, a1, a2, f, vis, *,
                 theta: float, lam: int, chunk: int):
    """The fused AW imaging program on ``uvw``'s device: uniform weights
    on the unmirrored uvw in wavelengths, v ≥ 0 mirroring, the AW gridder
    (each record's w-plane closest to its mirrored w, A-kernels of its
    antennas), Hermitian completion and the centred inverse FFT.  Returns
    ``(img, img.max())`` as tensors."""
    uvw0 = uvw_lambda(f, uvw)
    wt = doweight(theta, lam, uvw0, torch.ones_like(vis))
    uvw1, vis1 = mirror_uvw(uvw0, vis)
    guv = aw_imaging(theta, lam, wkerns, wbins, akerns, uvw1,
                     (a1, a2), wt * vis1, chunk=chunk)
    img = ifft_centered(make_grid_hermitian(guv)).real
    return img, torch.max(img)


def aw_image(vis_data: VisData, wkerns, wbins, akerns, *,
             theta: float = 0.008, lam: int = 300000,
             n: Optional[int] = None, precision: str = "single",
             device="cuda") -> WImage:
    """Fused AW-projection dirty image of in-memory visibilities through
    the unconjugated bank ``wkerns`` ``[nw, qpx, qpx, s, s]`` with plane
    centres ``wbins`` ``[nw]`` and the A-kernels ``akerns`` ``[nant, s,
    s]`` (numpy or tensors) on ``device`` (``"cuda"`` runs the CUDA fused
    gridder, ``"cpu"`` the plain scatter).  ``n`` caps the record count."""
    prec = _precision(precision)
    uvw, f, vis = idg_inputs(vis_data, n=n, precision=precision,
                             device=device)
    n = vis.shape[0]
    bank, wb = _bank(wkerns, wbins, prec, device)
    ak = torch.as_tensor(akerns, dtype=prec.complex, device=device)
    a1, a2 = (torch.as_tensor(a.astype(np.int32), device=device)
              for a in _ant_ids(vis_data, n))
    img, mx = _aw_pipeline(bank, wb, ak, uvw, a1, a2, f, vis,
                           theta=theta, lam=lam, chunk=_vis_chunk(n))
    return WImage(img, float(mx))


def _predict_pipeline(wkerns, wbins, img, uvw, f, *, theta: float, lam: int,
                      chunk: int):
    """Model image → centred FFT → bank gather at the records' unmirrored
    uvw in wavelengths, each with the w-plane closest to its w."""
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
    img = _model_tensor(model, theta, lam, prec, device)
    uvw, f = _uvw_freq(vis_data, n, prec, device)
    bank, wb = _bank(wkerns, wbins, prec, device)
    vis = _predict_pipeline(bank, wb, img, uvw, f, theta=theta, lam=lam,
                            chunk=_vis_chunk(uvw.shape[0]))
    return _prediction(vis, 0, "wproj_degridder")


def w_predict(wfile: str, datfile: str, modelfile: str,
              n: Optional[int] = None, outfile: Optional[str] = None,
              config: ImagingConfig = ImagingConfig(), device="cuda"):
    """w-projection prediction run from HDF5 files: ``/vis`` records, the
    ``/wkern`` bank and the ``/img`` model in, ``/vis/model`` out.
    Returns ``(predicted ndarray, peak |vis|)``."""
    data = load_vis_data(datfile)
    wkerns, wbins = get_wkernels(wfile, config.grid.theta)
    img = h5.read_dataset(modelfile, schema.IMG_DATASET)
    res = w_predict_vis(data, wkerns, wbins, img, theta=config.grid.theta,
                        lam=config.grid.lam, n=n,
                        precision=config.precision_name, device=device)
    pred = res.vis.cpu().numpy()
    _write_prediction(outfile, pred)
    return pred, res.peak
