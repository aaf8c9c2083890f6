"""The imaging inputs in HDF5 (port of the readers of
``ska_sdp_tpu/models/dataset.py``): the ``/vis`` tree as :class:`VisData`,
the A-kernels and the w-kernel bank, and the record geometry and flat slab
reader of the streamed and sharded runs.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from . import h5, schema


class VisData(NamedTuple):
    vis: np.ndarray        # [n] complex — channel 0
    uvw: np.ndarray        # [n, 3] float (metres)
    antenna1: np.ndarray   # [n] int64
    antenna2: np.ndarray   # [n] int64
    time: np.ndarray       # [n] float
    frequency: float       # channel 0 (Hz)
    vis_chan: np.ndarray = None    # [n, nch] complex — all channels
    frequencies: np.ndarray = None  # [nch] float64 (Hz)


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


def require_file(path: str) -> None:
    p = h5.fix_ext(path)
    if not os.path.exists(p):
        raise FileNotFoundError(f"input HDF5 file does not exist: {p}")


def load_vis_data(datfile: str) -> VisData:
    """Read the ``/vis`` tree.  The trailing axis of ``/vis/vis`` is the
    channel; ``vis``/``frequency`` keep channel 0 (the reference
    semantics), ``vis_chan``/``frequencies`` hold every channel."""
    require_file(datfile)
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


def _closest(sorted_pairs, x: float) -> str:
    vals = [v for v, _ in sorted_pairs]
    idx = int(np.argmin([abs(v - x) for v in vals]))
    return sorted_pairs[idx][1]


def get_akernels(afile: str, theta: float, t: float, f: float) -> np.ndarray:
    """Per-antenna A-kernels at the closest time and frequency, stacked as
    ``[nant, s, s]`` complex128.  The closest frequency is searched in the
    frequency list (the reference's fix of the original, which searched
    the time list)."""
    require_file(afile)
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


def get_wkernels(wfile: str, theta: float):
    """The w-kernel bank sorted by plane centre: ``([nw, qpx, qpx, s, s]
    complex128 unconjugated, [nw] float64 centres)``."""
    require_file(wfile)
    wbins = schema.parse_sorted(h5.list_group(wfile,
                                              schema.wkern_group(theta)))
    names = [schema.wkern_dataset(theta, name) for _, name in wbins]
    bank = h5.read_datasets_stacked(wfile, names, dtype=np.complex128)
    return bank, np.array([v for v, _ in wbins], dtype=np.float64)


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


def flat_vis_reader(datfile: str, per_row: int, nch: int = 1):
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
