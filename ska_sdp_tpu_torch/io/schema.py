"""HDF5 dataset-tree schema of the SKA1-Low bundles (port of the parts of
``ska_sdp_tpu/io/schema.py`` the IDG path reads and writes):

  visibility file:
    /vis/vis        [ntime, nbl, nch] complex  (n = ntime·nbl records)
    /vis/uvw        [n, 3]      float64    (metres)
    /vis/antenna1   [n]         int64
    /vis/antenna2   [n]         int64
    /vis/time       [n]         float64    (MJD UTC)
    /vis/frequency  [nch]       float64    (Hz)

  image output:
    /img            [n, n] float64

Complex values are the {r, i} float64 compound type (h5py's native
complex mapping), so files interoperate with the reference package.
"""

from __future__ import annotations

VIS_GROUP = "/vis"
VIS_VIS = "/vis/vis"
VIS_UVW = "/vis/uvw"
VIS_ANTENNA1 = "/vis/antenna1"
VIS_ANTENNA2 = "/vis/antenna2"
VIS_TIME = "/vis/time"
VIS_FREQUENCY = "/vis/frequency"
IMG_DATASET = "/img"
