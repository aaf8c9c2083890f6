"""Bank w-projection, fused AW, IDG and IDG-AW imaging and prediction
pipelines (port of the ``--mode w``, ``--mode aw [--idg]``, ``--mode idg``
and ``--mode predict [--idg [--aterms]]`` paths of
``ska_sdp_tpu/models/dataset.py``), and the PSF-normalised imaging of
``--mode simple``, ``conv`` and ``wcache`` (the reference CLI's branch).

Each path has an in-memory entry that runs on a given device and a file
entry that reads HDF5, calls it and writes HDF5:

  ==========================  ====================  =========================
  path                        in memory             file
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

There is no PSF normalisation on these paths; ``psf_image`` runs
``models.imaging.do_imaging``, which divides the image and the PSF by the
PSF peak.

``device_phases=True`` runs an imaging program as separately synchronised,
timed stages (the reference's ``--device-phases``): ``_idg_staged``
(``idg_gridding``), ``_wproj_staged`` (``w_gridding``, which also writes
the ``--dump-intermediates`` tree), ``_aw_fused_staged`` and
``_aw_idg_staged`` (``aw_gridding``).  Every file entry takes a
``PhaseTimer`` and records the reference's phase names in it.

Long ``--mode w`` runs grid in slabs: ``w_image_slabs`` (every record in
memory, global uniform weights) and ``w_image_streamed`` (two streamed
passes over ``io.stream.SlabPrefetcher`` readers, the weights from a
histogram of the first) keep the running uv-grid on the device and hand
it to a callback after every slab; the file entries
``w_gridding_checkpointed`` and ``w_gridding_out_of_core`` bind the
callback to ``utils.checkpoint.save`` and resume from its file.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import ImagingConfig
from ..io import h5, schema
from ..kernels import (_note_drops, idg_aw_degridder, idg_aw_gridder,
                       idg_degridder, idg_gridder, wproj_degridder,
                       wproj_gridder)
from ..kernels.idg_aw_records import idg_aw_run_records
from ..kernels.idg_aw_stream import (_check_subgrid,
                                     idg_aw_grid_from_records_stream)
from ..kernels.idg_tile import idg_bin_records, idg_grid_from_records
from ..ops import (doweight, fft_centered, ifft_centered, make_grid_hermitian,
                   mirror_uvw, uvw_lambda)
from ..ops.idg import (fov_pad_finish, fov_pad_geometry, fov_pad_start,
                       kaiser_taper, taper_fine)
from ..ops.idg_aw import aw_screens
from ..ops.search import find_closest
from ..types import precision as _precision
from ..utils import hostmem
from ..utils.timing import COUNTERS, PhaseTimer, add, readback, span
from .imaging import ImagingResult, aw_imaging, do_imaging, mode_imgfn


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
    with span("sdp.device_prep"):
        g = idg_grid_inputs(uvw, f, vis, theta=theta, lam=lam,
                            fov_pad=fov_pad)
    guv, n_dropped = idg_gridder(
        g.grid_shape, g.p, g.w, g.vis, theta=g.theta, subgrid=subgrid,
        taper_beta=taper_beta)
    with span("sdp.finish"):
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


def to_device(x, device, *, np_dtype=None, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)`` after the host
    cast ``np.ascontiguousarray(x, np_dtype)`` when ``np_dtype`` is given,
    bit for bit.  On a CUDA device a numpy array whose buffer is
    registered as page-locked (``utils.hostmem``: handed over before) is
    copied asynchronously in its own dtype and cast on the card; the
    entries' readbacks wait for the copy.  Anything else takes the host
    cast (span ``sdp.host_prep.cast``) and a pageable copy.  The bytes
    copied from host memory to a card count in the open spans'
    ``h2d_bytes``, those from registered memory also in
    ``h2d_registered_bytes``; a tensor already on a card, or one that
    stays on the host, counts 0.  ``timing.COUNTERS`` counts the copies
    ``h2d/registered`` and ``h2d/pageable``."""
    got = (hostmem.pinned_copy(x, device)
           if torch.device(device).type == "cuda" else None)
    if got is not None:
        t, nbytes = got
        add("h2d_bytes", nbytes)
        add("h2d_registered_bytes", nbytes)
        COUNTERS.add("h2d/registered")
        if np_dtype is not None:
            t = t.to(hostmem.TORCH_DTYPE[np.dtype(np_dtype)])
        return t if dtype is None else t.to(dtype)
    if np_dtype is not None:
        with span("sdp.host_prep.cast", host_only=True):
            x = np.ascontiguousarray(x, np_dtype)
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if t.device.type != "cpu" and not (isinstance(x, torch.Tensor)
                                       and x.device.type != "cpu"):
        add("h2d_bytes", t.numel() * t.element_size())
        COUNTERS.add("h2d/pageable")
    return t


def _entry(name: str, vis_data: VisData, n: Optional[int], **counts):
    """The root span ``sdp.<name>`` of an in-memory entry over the first
    ``n`` records, with the entry's own ``counts`` beside ``records``,
    ``h2d_bytes`` and ``h2d_registered_bytes``."""
    return span(f"sdp.{name}", records=len(vis_data.uvw[:n]), h2d_bytes=0,
                h2d_registered_bytes=0, **counts)


def _uvw_freq(vis_data: VisData, n: Optional[int], prec, device):
    """``(uvw, f)`` tensors of the first ``n`` records on ``device``; the
    frequency's blocking copy first, so it waits for no copy of records."""
    f = to_device(vis_data.frequency, device, dtype=prec.real)
    uvw = to_device(vis_data.uvw[:n], device, np_dtype=prec.np_real)
    return uvw, f


def idg_inputs(vis_data: VisData, *, n: Optional[int] = None,
               precision: str = "single", device="cuda"):
    """``(uvw, f, vis)`` tensors of the first ``n`` records on ``device``."""
    prec = _precision(precision)
    uvw, f = _uvw_freq(vis_data, n, prec, device)
    vis = to_device(vis_data.vis[:n], device, np_dtype=prec.np_complex)
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
    with _entry("idg_image", vis_data, n):
        with span("sdp.host_prep"):
            uvw, f, vis = idg_inputs(vis_data, n=n, precision=precision,
                                     device=device)
        img, mx, n_dropped = _idg_pipeline(
            uvw, f, vis, theta=theta, lam=lam, subgrid=subgrid,
            taper_beta=taper_beta, fov_pad=fov_pad)
        nd = readback(n_dropped, int)
        _note_drops("idg_gridder", nd, "unfit records or run-table overflow")
        return IDGImage(img, readback(mx, float), nd)


def _idg_staged(uvw: torch.Tensor, f: torch.Tensor, vis: torch.Tensor, *,
                theta: float, lam: int, subgrid: int, taper_beta: float,
                timer: PhaseTimer, fov_pad: Optional[float] = None):
    """The IDG imaging program on ``uvw``'s device as four separately
    synchronised stages, timed by ``timer.device_stage``: ``preprocess``
    (wavelengths, weights, mirroring), ``bin+sort`` (the fixed-tile prep),
    ``idg-kernel+fold`` (the fixed-tile route's gridder) and
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
    fixed-tile route, whatever the subgrid) and records its stage times
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
    _write_image(outfile, img, timer)
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


def _aw_run_bound(a1, a2, n: int) -> int:
    """IDG-AW ``max_runs``: each pair's track splits at a handful of
    coarse-uv-tile crossings, so ``8·npair + n/128 + 64`` bounds the runs
    of track data; overflow beyond it is counted, not refused.  The
    distinct ``(a1, a2)`` pairs are counted where the ids are (numpy ids
    on the CPU): the sorted pair keys' steps, read once."""
    a1, a2 = torch.as_tensor(a1), torch.as_tensor(a2)
    with span("sdp.device_prep"):
        keys = torch.sort(a1.to(torch.int64) * 2**32
                          + a2.to(torch.int64)).values
        npair = (keys[1:] != keys[:-1]).sum() + (keys.numel() > 0)
    return 8 * readback(npair, int) + n // 128 + 64


def _stamps(akerns, prec, device) -> torch.Tensor:
    """The A-kernel stamps ``[nant, s, s]`` as ``prec.complex`` on
    ``device``."""
    if isinstance(akerns, torch.Tensor):
        return to_device(akerns, device, dtype=prec.complex)
    return to_device(akerns, device, np_dtype=prec.np_complex)


def _aw_screens(akerns, subgrid: int, theta: float, lam: int, fov_pad,
                prec, device) -> torch.Tensor:
    """Image-domain screens on ``device``, sampled at the gridding FOV's
    angular scale (``θ·n_grid/n`` with ``fov_pad``), built there from the
    stamps (numpy or a tensor) in complex128 and cast to
    ``prec.complex``."""
    n_t, n_g, _, _ = fov_pad_geometry(theta, lam, fov_pad)
    ak = _stamps(akerns, prec, device)
    with span("sdp.device_prep"):
        return aw_screens(ak, subgrid, fov_scale=n_g / n_t,
                          dtype=prec.complex)


_AW_DROP_REASON = ("their uv spread exceeded their pair-chunk's subgrid; the "
                   "data is not track-ordered enough for IDG-AW")


def _ant_ids(vis_data: VisData, n: int):
    """The first ``n`` records' antenna ids as int64 numpy, cast on the
    host (span ``sdp.host_prep.cast``) only where they are not."""
    ids = (vis_data.antenna1[:n], vis_data.antenna2[:n])
    if all(isinstance(a, np.ndarray) and a.dtype == np.int64 for a in ids):
        return ids
    with span("sdp.host_prep.cast", host_only=True):
        return tuple(np.asarray(a, np.int64) for a in ids)


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
    with span("sdp.device_prep"):
        g, a1, a2 = aw_grid_inputs(uvw, a1, a2, f, vis, theta=theta,
                                   lam=lam, fov_pad=fov_pad, layout=layout)
    guv, n_dropped = idg_aw_gridder(
        g.grid_shape, g.p, a1, a2, g.w, g.vis, screens, theta=g.theta,
        subgrid=subgrid, taper_beta=taper_beta, max_runs=max_runs,
        ordered=layout is not None)
    with span("sdp.finish"):
        img = _idg_finish(guv, g.n, g.grid_shape[0], g.crop_lo, subgrid,
                          taper_beta, uvw.dtype)
        return img, torch.max(img), n_dropped


def _detect_time_major_layout(a1, a2, time, n):
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
            a1, a2 = _ant_ids(vis_data, n)
            ak = _stamps(akerns, prec, device)
            uvw, f, vis = idg_inputs(vis_data, n=n, precision=precision,
                                     device=device)
            a1_d = to_device(a1, device, np_dtype=np.int32)
            a2_d = to_device(a2, device, np_dtype=np.int32)
            layout = _detect_time_major_layout(a1, a2, vis_data.time, n)
        max_runs = _aw_run_bound(a1_d, a2_d, n)
        screens = _aw_screens(ak, subgrid, theta, lam, fov_pad, prec, device)
        img, mx, n_dropped = _aw_idg_pipeline(
            screens, uvw, a1_d, a2_d, f, vis, theta=theta, lam=lam,
            subgrid=subgrid, taper_beta=taper_beta, max_runs=max_runs,
            fov_pad=fov_pad, layout=layout)
        nd = readback(n_dropped, int)
        _note_drops("idg_aw_gridder", nd, _AW_DROP_REASON)
        return IDGImage(img, readback(mx, float), nd)


def _aw_idg_staged(screens, uvw, a1, a2, f, vis, *, theta: float, lam: int,
                   subgrid: int, taper_beta: float, max_runs: int,
                   timer: PhaseTimer, fov_pad: Optional[float] = None):
    """The IDG-AW imaging program on ``uvw``'s device as four separately
    synchronised stages, timed by ``timer.device_stage``: ``preprocess``
    (wavelengths, weights, mirroring), ``run-sort`` (the streamed
    gridder's (pair, uv-tile) run prep, always sorting: the raster
    shortcut of :func:`aw_idg_image` is not taken), ``idg-aw-kernel`` (the
    streamed gridder) and ``hermitian+ifft+taper``; ``fov_pad`` as in
    :func:`_aw_idg_pipeline`.  Returns ``(img, image max, n_dropped)``."""
    _check_subgrid(subgrid)
    n, n_grid, theta_g, crop_lo = fov_pad_geometry(theta, lam, fov_pad)
    shape = (n_grid, n_grid)
    timer.dispatch_floor(uvw.device)

    def prep(uvw, f, vis):
        g = idg_grid_inputs(uvw, f, vis, theta=theta, lam=lam,
                            fov_pad=fov_pad)
        return g.p, g.w, g.vis

    p, w, vis1 = timer.device_stage("preprocess", prep, uvw, f, vis)
    recs = timer.device_stage(
        "run-sort", idg_aw_run_records, shape, p, a1, a2, w, vis1.real,
        vis1.imag, subgrid=subgrid, max_runs=max_runs,
        nant=screens.shape[0])
    guv = timer.device_stage(
        "idg-aw-kernel", idg_aw_grid_from_records_stream, *recs[:7], shape,
        screens.to(torch.complex64).contiguous(), theta=theta_g,
        subgrid=subgrid, taper_beta=taper_beta)

    def image(guv):
        img = _idg_finish(guv, n, n_grid, crop_lo, subgrid, taper_beta,
                          uvw.dtype)
        return img, torch.max(img)

    img, mx = timer.device_stage("hermitian+ifft+taper", image, guv)
    return img, float(mx), int(recs[7])


def _aw_fused_staged(wkerns, wbins, akerns, uvw, a1, a2, f, vis, *,
                     theta: float, lam: int, chunk: int, timer: PhaseTimer):
    """The fused AW imaging program (:func:`_aw_pipeline`) on ``uvw``'s
    device as three separately synchronised stages: ``preprocess``
    (wavelengths, weights, mirroring), ``aw-fused-kernel`` (the fused AW
    gridder) and ``hermitian+ifft``.  Returns ``(img, image max)``."""
    timer.dispatch_floor(uvw.device)

    def prep(uvw, f, vis):
        uvw0 = uvw_lambda(f, uvw)
        wt = doweight(theta, lam, uvw0, torch.ones_like(vis))
        uvw1, vis1 = mirror_uvw(uvw0, vis)
        return uvw1, wt * vis1

    uvw1, wvis = timer.device_stage("preprocess", prep, uvw, f, vis)
    guv = timer.device_stage("aw-fused-kernel", aw_imaging, theta, lam,
                             wkerns, wbins, akerns, uvw1, (a1, a2), wvis,
                             chunk=chunk)
    img, mx = timer.device_stage("hermitian+ifft", _hermitian_image, guv)
    return img, float(mx)


def _hermitian_image(guv: torch.Tensor):
    """Hermitian completion and the centred inverse FFT: ``(img, max)``."""
    img = ifft_centered(make_grid_hermitian(guv)).real
    return img, torch.max(img)


def _write_image(outfile: Optional[str], img: np.ndarray,
                 timer: PhaseTimer) -> None:
    if outfile is not None:
        with timer.phase("write/img"):
            h5.create_file(outfile)
            h5.write_dataset(outfile, schema.IMG_DATASET,
                             img.astype(np.float64))


def aw_gridding(wfile: Optional[str], afile: str, datfile: str,
                n: Optional[int] = None, outfile: Optional[str] = None,
                config: ImagingConfig = ImagingConfig(),
                timer: Optional[PhaseTimer] = None,
                idg: bool = False, fov_pad: Optional[float] = None,
                subgrid: int = 64, device_phases: bool = False,
                device="cuda"):
    """AW imaging run from HDF5 files, the reference's argument order.
    ``idg=False`` is fused AW-projection (:func:`aw_image`: the ``wfile``
    bank, A-kernels from ``afile`` at the data's first time and its
    frequency).  ``idg=True`` is IDG-AW (:func:`aw_idg_image`, screens from
    the same A-kernels; ``wfile`` may be None); its dropped records are
    warned about and set ``timer.counters["idg_aw/dropped"]``.
    ``device_phases`` runs :func:`_aw_fused_staged` or
    :func:`_aw_idg_staged` and records their stage times in ``timer``.
    Returns ``(image max, image as numpy)`` and optionally writes
    ``/img``."""
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
            a1, a2 = (torch.as_tensor(a.astype(np.int32), device=device)
                      for a in _ant_ids(data, n))
            uvw, f, vis = idg_inputs(data, n=n, precision=prec,
                                     device=device)
            img_t, mx, nd = _aw_idg_staged(
                _aw_screens(akerns, subgrid, theta, lam, fov_pad, prec,
                            device), uvw, a1, a2, f, vis,
                theta=theta, lam=lam, subgrid=subgrid, taper_beta=12.0,
                max_runs=_aw_run_bound(a1, a2, n), timer=timer,
                fov_pad=fov_pad)
            _note_drops("idg_aw_gridder", nd, _AW_DROP_REASON)
        elif idg:
            res = aw_idg_image(data, akerns, theta=theta, lam=lam, n=n,
                               subgrid=subgrid, fov_pad=fov_pad,
                               precision=prec, device=device)
            img_t, mx, nd = res
        elif device_phases:
            uvw, f, vis = idg_inputs(data, n=n, precision=prec,
                                     device=device)
            bank, wb = _bank(wkerns, wbins, prec, device)
            a1, a2 = (torch.as_tensor(a.astype(np.int32), device=device)
                      for a in _ant_ids(data, n))
            img_t, mx = _aw_fused_staged(
                bank, wb, torch.as_tensor(akerns, dtype=prec.complex,
                                          device=device),
                uvw, a1, a2, f, vis, theta=theta, lam=lam,
                chunk=_vis_chunk(n), timer=timer)
        else:
            img_t, mx = aw_image(data, wkerns, wbins, akerns, theta=theta,
                                 lam=lam, n=n, precision=prec,
                                 device=device)
        img = img_t.cpu().numpy()
    if idg:
        timer.counters["idg_aw/dropped"] = float(nd)
    _write_image(outfile, img, timer)
    return mx, img


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
    with span("sdp.device_prep"):
        d = degrid_inputs(img, uvw, f, theta=theta, lam=lam,
                          subgrid=subgrid, taper_beta=taper_beta,
                          fov_pad=fov_pad)
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
    with span("sdp.device_prep"):
        d = degrid_inputs(img, uvw, f, theta=theta, lam=lam,
                          subgrid=subgrid, taper_beta=taper_beta,
                          fov_pad=fov_pad)
    return idg_aw_degridder(tuple(d.grid.shape), d.p, a1, a2, d.w, d.grid,
                            screens, theta=d.theta, subgrid=subgrid,
                            taper_beta=taper_beta, max_runs=max_runs)


def _model_tensor(model, theta: float, lam: int, prec, device):
    n_grid = int(round(theta * lam))
    if tuple(model.shape) != (n_grid, n_grid):
        raise ValueError(
            f"model image {tuple(model.shape)} does not match grid "
            f"({n_grid}, {n_grid}) for theta={theta}, lam={lam}")
    return to_device(model, device, dtype=prec.real)


def _prediction(vis: torch.Tensor, n_dropped, kind: str) -> Prediction:
    nd = readback(n_dropped, int)
    _note_drops(kind, nd, "predictions are 0 there; the data is not "
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
    n = n if n is not None else vis_data.uvw.shape[0]
    with _entry("aw_predict_vis", vis_data, n):
        with span("sdp.host_prep"):
            img = _model_tensor(model, theta, lam, prec, device)
            a1, a2 = _ant_ids(vis_data, n)
            ak = _stamps(akerns, prec, device)
            uvw, f = _uvw_freq(vis_data, n, prec, device)
            a1_d = to_device(a1, device, np_dtype=np.int32)
            a2_d = to_device(a2, device, np_dtype=np.int32)
        max_runs = _aw_run_bound(a1_d, a2_d, n)
        screens = _aw_screens(ak, subgrid, theta, lam, fov_pad, prec, device)
        vis, n_dropped = _aw_idg_predict_pipeline(
            screens, img, uvw, a1_d, a2_d, f, theta=theta, lam=lam,
            subgrid=subgrid, taper_beta=taper_beta, max_runs=max_runs,
            fov_pad=fov_pad)
        return _prediction(vis, n_dropped, "idg_aw_degridder")


def _write_prediction(outfile: Optional[str], pred: np.ndarray,
                      timer: PhaseTimer, phase: str = "write/vis") -> None:
    if outfile is not None:
        with timer.phase(phase):
            h5.create_file(outfile)
            h5.write_dataset(outfile, schema.MODEL_VIS_DATASET,
                             pred.astype(np.complex128))


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
        res = idg_predict_vis(data, img, theta=config.grid.theta,
                              lam=config.grid.lam, n=n, subgrid=subgrid,
                              taper_beta=taper_beta, fov_pad=fov_pad,
                              precision=config.precision_name, device=device)
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
        res = aw_predict_vis(data, akerns, img, theta=config.grid.theta,
                             lam=config.grid.lam, n=n, subgrid=subgrid,
                             taper_beta=taper_beta, fov_pad=fov_pad,
                             precision=config.precision_name, device=device)
        pred = res.vis.cpu().numpy()
    timer.counters["idg_aw/dropped"] = float(res.n_dropped)
    _write_prediction(outfile, pred, timer)
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
    with span("sdp.device_prep"):
        g = idg_grid_inputs(uvw, f, vis, theta=theta, lam=lam)
        wbin = find_closest(wbins, g.w)
    guv = wproj_gridder(bank_conj, g.grid_shape, g.p, wbin, g.vis,
                        chunk=chunk)
    with span("sdp.finish"):
        return _hermitian_image(guv)


def _bank(wkerns, wbins, prec, device):
    """``(bank, centres)`` tensors on ``device`` in the run's precision."""
    return (to_device(wkerns, device, dtype=prec.complex),
            to_device(wbins, device, dtype=prec.real))


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
            bank, wb = _bank(wkerns, wbins, prec, device)
        img, mx = _wproj_pipeline(torch.conj(bank).resolve_conj(), wb, uvw,
                                  f, vis, theta=theta, lam=lam,
                                  chunk=_vis_chunk(vis.shape[0]))
        return WImage(img, readback(mx, float))


def _wproj_staged(bank_conj, wbins, uvw, f, vis, *, theta: float, lam: int,
                  chunk: int, timer: PhaseTimer,
                  dump_to: Optional[str] = None):
    """The w-projection imaging program (:func:`_wproj_pipeline`) on
    ``uvw``'s device as three separately synchronised stages, timed by
    ``timer.device_stage``: ``preprocess`` (wavelengths, weights,
    mirroring, each record's closest w-plane), ``scatter`` (the bank
    scatter into a zero grid) and ``hermitian+ifft``.  ``dump_to`` writes
    the ``/debug`` tree: the uv-grid planes ``uvgrid_re``/``uvgrid_im`` and
    the image ``img`` as float32, the planes ``wbin`` as int32.  Returns
    ``(img, image max)``."""
    timer.dispatch_floor(uvw.device)

    def prep(uvw, f, vis):
        g = idg_grid_inputs(uvw, f, vis, theta=theta, lam=lam)
        return g.grid_shape, g.p, find_closest(wbins, g.w), g.vis

    shape, p, wbin, vis1 = timer.device_stage("preprocess", prep, uvw, f,
                                              vis)
    guv = timer.device_stage("scatter", wproj_gridder, bank_conj, shape, p,
                             wbin, vis1, chunk=chunk)
    img, mx = timer.device_stage("hermitian+ifft", _hermitian_image, guv)
    if dump_to is not None:
        h5.create_file(dump_to)
        for name, arr in (("uvgrid_re", guv.real.to(torch.float32)),
                          ("uvgrid_im", guv.imag.to(torch.float32)),
                          ("wbin", wbin.to(torch.int32)),
                          ("img", img.to(torch.float32))):
            h5.write_dataset(dump_to, f"/debug/{name}", arr.cpu().numpy())
    return img, float(mx)


def w_gridding(wfile: str, datfile: str, n: Optional[int] = None,
               outfile: Optional[str] = None,
               config: ImagingConfig = ImagingConfig(),
               timer: Optional[PhaseTimer] = None,
               device_phases: bool = False,
               dump_intermediates: Optional[str] = None, device="cuda"):
    """w-projection imaging run from HDF5 files: ``/vis`` and the
    ``/wkern`` bank in, optionally ``/img`` (float64) out.
    ``device_phases`` or ``dump_intermediates`` (a file for the ``/debug``
    tree) runs the stage-synchronised :func:`_wproj_staged`.  Returns
    ``(image max, image as numpy)``."""
    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/wkern"):
        wkerns, wbins = get_wkernels(wfile, theta)
    if device_phases or dump_intermediates:
        uvw, f, vis = idg_inputs(data, n=n, precision=prec, device=device)
        bank, wb = _bank(wkerns, wbins, prec, device)
        img_t, mx = _wproj_staged(
            torch.conj(bank).resolve_conj(), wb, uvw, f, vis, theta=theta,
            lam=lam, chunk=_vis_chunk(vis.shape[0]), timer=timer,
            dump_to=dump_intermediates)
        img = img_t.cpu().numpy()
    else:
        with timer.phase("h2d+compile+grid+fft"):
            res = w_image(data, wkerns, wbins, theta=theta, lam=lam, n=n,
                          precision=prec, device=device)
            img, mx = res.image.cpu().numpy(), res.image_max
    _write_image(outfile, img, timer)
    return mx, img


# ---------------------------------------------------------------------------
# Slab-wise w-projection: checkpointed and out-of-core (streamed) runs
# ---------------------------------------------------------------------------


SlabCallback = Callable[[torch.Tensor, int], None]


def _start_grid(shape, grid, dtype, device) -> torch.Tensor:
    """The running uv-grid on ``device``: zeros, or a copy of ``grid``
    (numpy or tensor, e.g. a checkpoint's planes)."""
    if grid is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.as_tensor(grid).to(device=device, dtype=dtype).clone()


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
        img, mx = _hermitian_image(grid)
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
    bank, wb = _bank(wkerns, wbins, prec, device)
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
    from ..io.stream import SlabPrefetcher
    from ..types import SPEED_OF_LIGHT

    n_grid = int(round(theta * lam))
    size = n_grid * n_grid
    scale = frequency / SPEED_OF_LIGHT
    counts = torch.zeros((size,), dtype=torch.int64, device=device)
    reader = SlabPrefetcher({"uvw": uvw_reader}, n, slab)
    for _, sl in reader:
        uvw_l = torch.as_tensor(sl["uvw"], device=device) * scale
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
    from ..io.stream import SlabPrefetcher
    from ..types import SPEED_OF_LIGHT

    timer = timer or PhaseTimer()
    prec = _precision(precision)
    n_grid = int(round(theta * lam))
    with timer.phase("weight/histogram"):
        counts = stream_weight_counts(readers["uvw"], n, frequency,
                                      theta=theta, lam=lam, slab=slab,
                                      device=device, timer=timer)
    bank, wb = _bank(wkerns, wbins, prec, device)
    scale = frequency / SPEED_OF_LIGHT
    p2 = SlabPrefetcher(readers, n, slab, start=start)

    def slabs():
        for s0, sl in p2:
            uvw_l = (torch.as_tensor(sl["uvw"], device=device)
                     * scale).to(prec.real)
            flat = _flat_cells(n_grid, uvw_l / lam).clamp(0, n_grid ** 2 - 1)
            wt = (1.0 / counts[flat].to(torch.float64)).to(prec.real)
            vis = torch.as_tensor(np.asarray(sl["vis"], prec.np_complex),
                                  device=device)
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


class HostCopy:
    """The host side of a slab callback: ``copy(grid)`` copies the grid
    into one host buffer reused from slab to slab, page-locked when the
    grid is on a CUDA device (a pageable copy of a 2400² grid runs at a
    fraction of the link's rate), and returns it as numpy.  The next copy
    overwrites it."""

    def __init__(self):
        self._buf: Optional[torch.Tensor] = None

    def __call__(self, grid: torch.Tensor) -> np.ndarray:
        buf = self._buf
        if buf is None or buf.shape != grid.shape or buf.dtype != grid.dtype:
            buf = self._buf = torch.empty(grid.shape, dtype=grid.dtype,
                                          pin_memory=grid.is_cuda)
        buf.copy_(grid)
        return buf.numpy()


def _checkpoint_writer(path: str, n: int, fpr: int, prec) -> SlabCallback:
    """``on_slab`` that copies the device grid to the host
    (:class:`HostCopy`) and writes it to the checkpoint ``path`` at the
    run's real precision."""
    from ..utils import checkpoint as ckpt

    copy = HostCopy()

    def write(grid: torch.Tensor, nxt: int) -> None:
        g = copy(grid)
        ckpt.save(path, g.real.astype(prec.np_real),
                  g.imag.astype(prec.np_real), nxt, n, fpr=fpr)

    return write


def _resume(path: str, n_grid: int, n: int, fpr: int, prec):
    """``(start, grid)`` from the checkpoint ``path`` if it belongs to
    this run, else ``(0, None)``."""
    from ..utils import checkpoint as ckpt

    state = ckpt.load(path, n_grid, n, fpr=fpr)
    if state is None:
        return 0, None
    g_re, g_im, start = state
    return start, (g_re.astype(prec.np_real)
                   + 1j * g_im.astype(prec.np_real)).astype(prec.np_complex)


def _w_fingerprint(theta: float, lam: int, wkerns, prec, route: str) -> int:
    """The reference's fingerprint of a w-projection run (so a checkpoint
    resumes across the two packages)."""
    from ..utils import checkpoint as ckpt

    shape = tuple(int(d) for d in np.shape(wkerns))
    return ckpt.fingerprint(theta, lam, shape, str(prec.np_real), route)


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
    (:func:`w_image_slabs`); a run finding a checkpoint of the same
    configuration resumes from it, and the file is removed on success.
    ``_max_slabs`` stops early (a test's interruption).  Returns ``(image
    max, image as numpy)``, or ``(None, None)`` when stopped early."""
    from ..utils import checkpoint as ckpt

    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    with timer.phase("ingest/vis"):
        data = load_vis_data(datfile)
    with timer.phase("ingest/wkern"):
        wkerns, wbins = get_wkernels(wfile, theta)
    n = min(n, data.vis.shape[0]) if n is not None else data.vis.shape[0]
    fpr = _w_fingerprint(theta, lam, wkerns, prec, "wproj")
    start, grid = _resume(checkpoint, int(round(theta * lam)), n, fpr, prec)
    res = w_image_slabs(data, wkerns, wbins, theta=theta, lam=lam, n=n,
                        slab=slab, precision=prec, device=device,
                        start=start, grid=grid,
                        on_slab=_checkpoint_writer(checkpoint, n, fpr, prec),
                        max_slabs=_max_slabs, timer=timer)
    if res is None:
        return None, None
    img = res.image.cpu().numpy()
    _write_image(outfile, img, timer)
    ckpt.remove(checkpoint)
    return res.image_max, img


def vis_record_geometry(datfile: str):
    """``(records_total, records_per_row, nch)`` of the ``/vis/vis`` block.
    A record is one (time, baseline) row, the unit ``/vis/uvw`` is indexed
    by; multi-channel files carry ``nch`` values per record in the
    trailing axis (trailing axis == len(``/vis/frequency``) > 1, as
    :func:`load_vis_data` detects it), which the counts leave out."""
    vshape = h5.dataset_shape(datfile, schema.VIS_VIS)
    nch = h5.read_dataset(datfile, schema.VIS_FREQUENCY).ravel().shape[0]
    if not (nch > 1 and len(vshape) >= 1 and vshape[-1] == nch):
        nch = 1
    total = int(np.prod(vshape)) // nch
    per_row = (int(np.prod(vshape[1:])) // nch) if len(vshape) > 1 else 1
    return total, max(per_row, 1), nch


def _flat_vis_reader(datfile: str, per_row: int, nch: int = 1):
    """Reader of flat record-order slices of the ``/vis/vis`` block
    (channel 0 of a multi-channel file)."""

    def read(start: int, count: int) -> np.ndarray:
        t0 = start // per_row
        t1 = (start + count - 1) // per_row + 1
        block = h5.read_dataset_slice(datfile, schema.VIS_VIS, t0, t1 - t0
                                      ).reshape(-1, nch)[:, 0]
        off = start - t0 * per_row
        return block[off:off + count]

    return read


def w_gridding_out_of_core(wfile: str, datfile: str, checkpoint: str,
                           n: Optional[int] = None,
                           outfile: Optional[str] = None,
                           slab: int = 1 << 20,
                           config: ImagingConfig = ImagingConfig(),
                           timer: Optional[PhaseTimer] = None,
                           _max_slabs: Optional[int] = None,
                           device="cuda"):
    """Streamed w-projection imaging of a dataset larger than host memory:
    :func:`w_image_streamed` over slab readers of the vis file (HDF5 reads
    on a prefetch thread overlap the gridding), checkpointed after every
    slab as :func:`w_gridding_checkpointed` is, with the route
    ``"wproj-ooc"`` in the fingerprint.  Returns ``(image max, image as
    numpy)``, or ``(None, None)`` when ``_max_slabs`` stopped it."""
    from ..utils import checkpoint as ckpt

    timer = timer or PhaseTimer()
    prec = config.precision
    theta, lam = config.grid.theta, config.grid.lam
    _require_file(datfile)
    n_total, per_row, nch = vis_record_geometry(datfile)
    n = min(n, n_total) if n is not None else n_total
    freq = float(h5.read_dataset(datfile, schema.VIS_FREQUENCY).ravel()[0])
    with timer.phase("ingest/wkern"):
        wkerns, wbins = get_wkernels(wfile, theta)
    readers = {"uvw": lambda s0, c: h5.read_dataset_slice(
                   datfile, schema.VIS_UVW, s0, c),
               "vis": _flat_vis_reader(datfile, per_row, nch)}
    fpr = _w_fingerprint(theta, lam, wkerns, prec, "wproj-ooc")
    start, grid = _resume(checkpoint, int(round(theta * lam)), n, fpr, prec)
    res = w_image_streamed(readers, n, freq, wkerns, wbins, theta=theta,
                           lam=lam, slab=slab, precision=prec,
                           device=device, start=start, grid=grid,
                           on_slab=_checkpoint_writer(checkpoint, n, fpr,
                                                      prec),
                           max_slabs=_max_slabs, timer=timer)
    if res is None:
        return None, None
    img = res.image.cpu().numpy()
    _write_image(outfile, img, timer)
    ckpt.remove(checkpoint)
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
    with span("sdp.device_prep"):
        uvw0 = uvw_lambda(f, uvw)
        wt = doweight(theta, lam, uvw0, torch.ones_like(vis))
        uvw1, vis1 = mirror_uvw(uvw0, vis)
        wvis = wt * vis1
    guv = aw_imaging(theta, lam, wkerns, wbins, akerns, uvw1, (a1, a2), wvis,
                     chunk=chunk)
    with span("sdp.finish"):
        return _hermitian_image(guv)


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
            bank, wb = _bank(wkerns, wbins, prec, device)
            ak = _stamps(akerns, prec, device)
            uvw, f, vis = idg_inputs(vis_data, n=n, precision=precision,
                                     device=device)
            n = vis.shape[0]
            a1, a2 = (to_device(a, device, np_dtype=np.int32)
                      for a in _ant_ids(vis_data, n))
        img, mx = _aw_pipeline(bank, wb, ak, uvw, a1, a2, f, vis,
                               theta=theta, lam=lam, chunk=_vis_chunk(n))
        return WImage(img, readback(mx, float))


def _predict_pipeline(wkerns, wbins, img, uvw, f, *, theta: float, lam: int,
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
            bank, wb = _bank(wkerns, wbins, prec, device)
        vis = _predict_pipeline(bank, wb, img, uvw, f, theta=theta, lam=lam,
                                chunk=_vis_chunk(uvw.shape[0]))
        return _prediction(vis, 0, "wproj_degridder")


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
        res = w_predict_vis(data, wkerns, wbins, img,
                            theta=config.grid.theta, lam=config.grid.lam,
                            n=n, precision=config.precision_name,
                            device=device)
        pred = res.vis.cpu().numpy()
    _write_prediction(outfile, pred, timer, "write/model-vis")
    return pred, res.peak


# ---------------------------------------------------------------------------
# PSF-normalised imaging: --mode simple, conv and wcache
# ---------------------------------------------------------------------------


def psf_image(vis_data: VisData, mode: str, *, theta: float = 0.008,
              lam: int = 300000, n: Optional[int] = None,
              wstep: float = 2000.0, precision: str = "single",
              device="cuda") -> ImagingResult:
    """PSF-normalised dirty image of in-memory visibilities on ``device``
    through ``mode``'s imaging function (``models.imaging.mode_imgfn``:
    ``simple``, ``conv`` or ``wcache`` with bin width ``wstep``) and
    ``do_imaging``.  ``conv`` and ``wcache`` grid through the bank scatter
    (the CUDA kernel on ``"cuda"``, its plain version on ``"cpu"``);
    ``simple`` runs no hand-written kernel.  ``n`` caps the record
    count."""
    prec = _precision(precision)
    uvw, f = _uvw_freq(vis_data, n, prec, device)
    m = uvw.shape[0]
    uvw0 = uvw_lambda(f, uvw)
    vis = torch.as_tensor(np.asarray(vis_data.vis[:m], prec.np_complex),
                          device=device)
    a1, a2 = (torch.as_tensor(a, device=device)
              for a in _ant_ids(vis_data, m))
    t = torch.as_tensor(np.asarray(vis_data.time[:m], prec.np_real),
                        device=device)
    return do_imaging(theta, lam, uvw0, a1, a2, t, vis_data.frequency, vis,
                      mode_imgfn(mode, theta, uvw0, wstep))


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
        res = psf_image(data, mode, theta=config.grid.theta,
                        lam=config.grid.lam, n=n, wstep=wstep,
                        precision=config.precision_name, device=device)
        img = res.image.cpu().numpy()
    if outfile is not None:
        with timer.phase("write/img"):
            h5.create_file(outfile)
            h5.write_dataset(outfile, schema.IMG_DATASET, img)
    return float(res.pmax), img
