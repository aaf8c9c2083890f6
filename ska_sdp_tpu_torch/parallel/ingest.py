"""Sharded ingest: each rank reads only its visibility slice (port of
``ska_sdp_tpu/parallel/ingest.py``).

Every rank reads its own contiguous block of records with sliced HDF5
reads (``io.h5.read_dataset_slice``): no rank holds the whole dataset, and
the bytes each reads scale as 1/P.  The returned tensors are the rank's
shard, on its device, and feed the ``parallel.sharded`` steps directly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io import h5, schema
from ..types import precision as _precision
from .mesh import Mesh, shard_range


def load_vis_sharded(datfile: str, mesh: Mesh, n: int | None = None,
                     precision: str = "single"):
    """This rank's ``(uvw [n/P, 3] metres, vis [n/P] channel 0, freq)``:
    tensors on ``mesh.device`` in the run's precision and the first
    channel's frequency in Hz.  ``n`` (default every record) is truncated
    to a multiple of the mesh size."""
    from ..models.dataset import vis_record_geometry

    prec = _precision(precision)
    n_total, nbl, nch = vis_record_geometry(datfile)
    n = min(n, n_total) if n is not None else n_total
    n -= n % mesh.size                  # equal shards
    sl = shard_range(n, mesh)
    s0, count = sl.start, sl.stop - sl.start

    uvw = h5.read_dataset_slice(datfile, schema.VIS_UVW, s0, count)
    t0 = s0 // nbl
    t1 = (s0 + count - 1) // nbl + 1
    block = np.asarray(h5.read_dataset_slice(
        datfile, schema.VIS_VIS, t0, t1 - t0)).reshape(-1, nch)[:, 0]
    off = s0 - t0 * nbl
    vis = block[off:off + count]
    freq = float(np.asarray(
        h5.read_dataset(datfile, schema.VIS_FREQUENCY)).ravel()[0])
    return (torch.as_tensor(np.asarray(uvw, prec.np_real), device=mesh.device),
            torch.as_tensor(np.asarray(vis, prec.np_complex),
                            device=mesh.device), freq)
