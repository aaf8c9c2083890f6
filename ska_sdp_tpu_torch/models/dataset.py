"""IDG imaging pipeline (port of the ``--mode idg`` path of
``ska_sdp_tpu/models/dataset.py``).

``idg_image`` images in-memory visibilities on a device;
``idg_gridding`` is the file entry point: read ``/vis``, ``idg_image``,
write ``/img``.  The device program is the reference's ``_idg_pipeline``:

    uvw → wavelengths → uniform weights → v ≥ 0 mirroring → IDG gridder
        → Hermitian completion → centred inverse FFT → ÷ fine taper
        → padded-FOV crop → image max

There is no PSF normalisation on this path.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ImagingConfig
from ..io import h5, schema
from ..kernels import _note_drops, idg_gridder
from ..ops import (doweight, ifft_centered, make_grid_hermitian, mirror_uvw,
                   uvw_lambda)
from ..ops.idg import fov_pad_finish, fov_pad_geometry, kaiser_taper, \
    taper_fine
from ..types import precision as _precision


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


def load_vis_data(datfile: str) -> VisData:
    """Read the ``/vis`` tree.  The trailing axis of ``/vis/vis`` is the
    channel; ``vis``/``frequency`` keep channel 0 (the reference
    semantics), ``vis_chan``/``frequencies`` hold every channel."""
    p = datfile if datfile.endswith(".h5") else datfile + ".h5"
    if not os.path.exists(p):
        raise FileNotFoundError(f"input HDF5 file does not exist: {p}")
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


def idg_inputs(vis_data: VisData, *, n: Optional[int] = None,
               precision: str = "single", device="cuda"):
    """``(uvw, f, vis)`` tensors of the first ``n`` records on ``device``."""
    prec = _precision(precision)
    n = n if n is not None else vis_data.vis.shape[0]
    uvw = torch.as_tensor(np.asarray(vis_data.uvw[:n], prec.np_real),
                          device=device)
    vis = torch.as_tensor(np.asarray(vis_data.vis[:n], prec.np_complex),
                          device=device)
    f = torch.tensor(vis_data.frequency, dtype=prec.real, device=device)
    return uvw, f, vis


def idg_image(vis_data: VisData, *, theta: float = 0.008,
              lam: int = 300000, n: Optional[int] = None,
              subgrid: int = 64, taper_beta: float = 12.0,
              fov_pad: Optional[float] = None, precision: str = "single",
              device="cuda") -> IDGImage:
    """Image-domain-gridding dirty image of in-memory visibilities on
    ``device`` (``"cuda"`` runs the CUDA gridder, ``"cpu"`` its plain
    version).  ``n`` caps the record count.  Dropped records are counted
    in ``kernels.drop_counters()`` and warned about once."""
    uvw, f, vis = idg_inputs(vis_data, n=n, precision=precision,
                             device=device)
    img, mx, n_dropped = _idg_pipeline(
        uvw, f, vis, theta=theta, lam=lam, subgrid=subgrid,
        taper_beta=taper_beta, fov_pad=fov_pad)
    nd = int(n_dropped)
    _note_drops("idg_gridder", nd, "unfit records or run-table overflow")
    return IDGImage(img, float(mx), nd)


def idg_gridding(datfile: str, n: Optional[int] = None,
                 outfile: Optional[str] = None,
                 config: ImagingConfig = ImagingConfig(),
                 subgrid: int = 64, taper_beta: float = 12.0,
                 fov_pad: Optional[float] = None, device="cuda"):
    """IDG imaging run from an HDF5 file: load ``/vis``, image on
    ``device``, optionally write ``/img`` (float64).  Returns
    ``(image max, image as numpy)``."""
    data = load_vis_data(datfile)
    res = idg_image(data, theta=config.grid.theta, lam=config.grid.lam,
                    n=n, subgrid=subgrid, taper_beta=taper_beta,
                    fov_pad=fov_pad, precision=config.precision_name,
                    device=device)
    img = res.image.cpu().numpy()
    if outfile is not None:
        h5.create_file(outfile)
        h5.write_dataset(outfile, schema.IMG_DATASET, img.astype(np.float64))
    return res.image_max, img
