"""HDF5 dataset-tree schema of the SKA1-Low bundles (port of the parts of
``ska_sdp_tpu/io/schema.py`` the ported paths read and write):

  visibility file:
    /vis/vis        [ntime, nbl, nch] complex  (n = ntime·nbl records)
    /vis/uvw        [n, 3]      float64    (metres)
    /vis/antenna1   [n]         int64
    /vis/antenna2   [n]         int64
    /vis/time       [n]         float64    (MJD UTC)
    /vis/frequency  [nch]       float64    (Hz)

  w-kernel file:
    /wkern/<theta>/<w>/kern     [qpx, qpx, s, s] complex (unconjugated)
      — one group per w-plane centre, named by the w value as text;
        readers parse the names as floats and sort numerically.

  A-kernel file:
    /akern/<theta>/<antenna>/<time>/<freq>/kern   [s, s] complex

  image output:
    /img            [n, n] float64
    /img_cube       [nch, n, n] float64   (--channels N; /img is its mean)

  predicted visibilities:
    /vis/model      [n] complex

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
IMG_CUBE_DATASET = "/img_cube"
MODEL_VIS_DATASET = "/vis/model"


def fmt_float(x: float) -> str:
    """Shortest clean decimal text for a float group name (e.g. '0.008')."""
    s = repr(float(x))
    return s[:-2] if s.endswith(".0") else s


def wkern_group(theta: float) -> str:
    return f"/wkern/{fmt_float(theta)}"


def wkern_dataset(theta: float, w_name: str) -> str:
    return f"{wkern_group(theta)}/{w_name}/kern"


def akern_group(theta: float) -> str:
    return f"/akern/{fmt_float(theta)}"


def akern_dataset(theta: float, ant: str, time: str, freq: str) -> str:
    return f"{akern_group(theta)}/{ant}/{time}/{freq}/kern"


def parse_sorted(names) -> list[tuple[float, str]]:
    """Group-member names parsed as floats, sorted numerically, as
    ``(value, name)`` pairs."""
    return sorted(((float(n), n) for n in names), key=lambda t: t[0])
