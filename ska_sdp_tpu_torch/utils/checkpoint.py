"""Checkpoint and resume of long w-projection runs (port of
``ska_sdp_tpu/utils/checkpoint.py``, the same file layout and fingerprint,
so that a checkpoint written by either package resumes in the other).

After each visibility slab the partial uv-grid and the number of records
already gridded are written to an HDF5 file, atomically (a tmp file, then
``os.replace``); an interrupted run resumes from the last completed slab.

A checkpoint carries a fingerprint of the run-defining configuration (θ,
λ, the kernel bank's shape, the precision and the route): resuming under
another bank, precision or weighting would mix inconsistent numerics into
the grid, so a mismatch rejects the file with a logged warning.  Every
rejection of an existing file is logged under the logger
``ska_sdp_tpu_torch.checkpoint``.

Layout: ``/ckpt/grid_re``, ``/ckpt/grid_im`` (``[n, n]`` at the run's real
precision: float32 for a single-precision run, float64 for a double one),
``/ckpt/next`` (float64 ``[1]``, records already gridded), ``/ckpt/total``
(float64 ``[1]``) and ``/ckpt/fpr`` (float64 ``[1]``, the fingerprint).
"""

from __future__ import annotations

import logging
import os
import zlib
from typing import Optional, Tuple

import numpy as np

from ..io import h5

log = logging.getLogger("ska_sdp_tpu_torch.checkpoint")

GRID_RE = "/ckpt/grid_re"
GRID_IM = "/ckpt/grid_im"
NEXT = "/ckpt/next"
TOTAL = "/ckpt/total"
FPR = "/ckpt/fpr"


def fingerprint(*parts) -> int:
    """CRC-32 of ``"|".join(repr(p) for p in parts)``.  The w-projection
    drivers hash ``(theta, lam, bank shape as a tuple of ints,
    str(precision.np_real), route)``, exactly as the reference does, so the
    two packages give the same number for the same run."""
    return zlib.crc32("|".join(repr(p) for p in parts).encode())


def save(path: str, grid_re: np.ndarray, grid_im: np.ndarray, next_vis: int,
         total: int, fpr: int = 0) -> None:
    """Atomically write a gridding checkpoint; float32 planes stay float32,
    any other real type is written as float64."""
    path = h5.fix_ext(path)
    tmp = path + ".tmp.h5"
    h5.create_file(tmp)
    grid_re = np.asarray(grid_re)
    dt = np.float32 if grid_re.dtype == np.float32 else np.float64
    h5.write_dataset(tmp, GRID_RE, np.asarray(grid_re, dt))
    h5.write_dataset(tmp, GRID_IM, np.asarray(grid_im, dt))
    h5.write_dataset(tmp, NEXT, np.asarray([float(next_vis)]))
    h5.write_dataset(tmp, TOTAL, np.asarray([float(total)]))
    h5.write_dataset(tmp, FPR, np.asarray([float(fpr)]))
    os.replace(tmp, path)


def load(path: str, n_grid: int, total: int,
         fpr: int = 0) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """``(grid_re, grid_im, next)`` of a checkpoint, or None if there is
    none or it does not belong to this run (another total, fingerprint or
    grid shape, or an unreadable file), each rejection logged."""
    path = h5.fix_ext(path)
    if not os.path.exists(path):
        return None
    try:
        tot = int(h5.read_dataset(path, TOTAL)[0])
        if tot != total:
            log.warning("checkpoint %s rejected: total %d != run total %d "
                        "(restarting from 0)", path, tot, total)
            return None
        try:
            got_fpr = int(h5.read_dataset(path, FPR)[0])
        except (KeyError, OSError):  # h5py's and the native layer's miss
            got_fpr = None          # a file written before fingerprints
        if got_fpr is not None and got_fpr != fpr:
            log.warning("checkpoint %s rejected: config fingerprint %s != %s "
                        "— different wkern bank/precision/θλ (restarting "
                        "from 0)", path, got_fpr, fpr)
            return None
        gre = h5.read_dataset(path, GRID_RE)
        gim = h5.read_dataset(path, GRID_IM)
        if gre.shape != (n_grid, n_grid):
            log.warning("checkpoint %s rejected: grid shape %s != (%d, %d) "
                        "(restarting from 0)", path, gre.shape, n_grid,
                        n_grid)
            return None
        nxt = int(h5.read_dataset(path, NEXT)[0])
        return gre, gim, nxt
    except Exception as e:      # any unreadable file restarts, logged
        log.warning("checkpoint %s unreadable (%s: %s) — restarting from 0",
                    path, type(e).__name__, e)
        return None


def remove(path: str) -> None:
    path = h5.fix_ext(path)
    if os.path.exists(path):
        os.remove(path)
