"""Sharded ingest: each rank reads only its visibility slice (port of
``ska_sdp_tpu/parallel/ingest.py``).

Every rank reads its own contiguous block of records with sliced HDF5
reads (``io.h5.read_dataset_slice``): no rank holds the whole dataset, and
the bytes each reads scale as 1/P.  The returned tensors are the rank's
shard, on its device, and feed the ``parallel.sharded`` steps directly.
"""

from __future__ import annotations

import numpy as np

from ..io import h5, schema
from ..io.inputs import flat_vis_reader, vis_record_geometry
from ..types import precision as _precision
from ..utils import hostmem
from .mesh import Mesh, shard_range


def load_vis_sharded(datfile: str, mesh: Mesh, n: int | None = None,
                     precision: str = "single"):
    """This rank's ``(uvw [n/P, 3] metres, vis [n/P] channel 0, freq)``:
    tensors on ``mesh.device`` in the run's precision and the first
    channel's frequency in Hz.  ``n`` (default every record) is truncated
    to a multiple of the mesh size."""
    prec = _precision(precision)
    n_total, nbl, nch = vis_record_geometry(datfile)
    n = min(n, n_total) if n is not None else n_total
    n -= n % mesh.size                  # equal shards
    sl = shard_range(n, mesh)
    s0, count = sl.start, sl.stop - sl.start

    uvw = h5.read_dataset_slice(datfile, schema.VIS_UVW, s0, count)
    vis = flat_vis_reader(datfile, nbl, nch)(s0, count)
    freq = float(np.asarray(
        h5.read_dataset(datfile, schema.VIS_FREQUENCY)).ravel()[0])
    return (hostmem.to_device(uvw, mesh.device, np_dtype=prec.np_real),
            hostmem.to_device(vis, mesh.device, np_dtype=prec.np_complex),
            freq)
