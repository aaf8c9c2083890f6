"""HDF5 I/O façade (port of ``ska_sdp_tpu/io/h5.py``): every file entry of
the port reads and writes through these functions, served by one of two
interchangeable backends with the same files:

* ``native``: the C++ layer in ``io/native/`` bound with ctypes
  (:mod:`.native_backend`), built at first use against the HDF5 1.10
  runtime; it needs no h5py;
* ``h5py``: :mod:`.h5py_backend`.

``SKA_SDP_TPU_H5_BACKEND`` picks one: ``native``, ``h5py`` or ``auto``
(the default): native where ``native/build.find_hdf5`` finds an HDF5 1.10
runtime, else h5py.  The reference's auto also falls back to h5py when
the native build fails; here a runtime that is found but does not build
or load raises, so no failure hides behind the other backend.  The
variable is read at each call; importing this module imports neither
backend.
"""

from __future__ import annotations

import os

CHOICES = ("auto", "native", "h5py")


def fix_ext(path: str) -> str:
    return path if path.endswith(".h5") else path + ".h5"


def backend_name() -> str:
    """The backend the next call takes: ``"native"`` or ``"h5py"``."""
    choice = os.environ.get("SKA_SDP_TPU_H5_BACKEND", "auto")
    if choice not in CHOICES:
        raise ValueError(f"SKA_SDP_TPU_H5_BACKEND={choice!r}: expected one "
                         f"of {', '.join(CHOICES)}")
    if choice == "auto":
        from .native.build import find_hdf5

        return "h5py" if find_hdf5().path is None else "native"
    return choice


def _backend():
    if backend_name() == "native":
        from . import native_backend

        return native_backend
    from . import h5py_backend

    return h5py_backend


def create_file(path: str) -> None:
    _backend().create_file(path)


def read_dataset(path: str, name: str, dtype=None):
    """A whole dataset; ``dtype`` converts (default: the stored dtype)."""
    return _backend().read_dataset(path, name, dtype=dtype)


def read_dataset_slice(path: str, name: str, start: int, count: int,
                       dtype=None):
    """Rows ``[start, start + count)`` along the leading axis."""
    return _backend().read_dataset_slice(path, name, start, count, dtype)


def read_datasets_stacked(path: str, names, dtype=None):
    """Same-shape datasets stacked on a new leading axis."""
    return _backend().read_datasets_stacked(path, names, dtype=dtype)


def write_dataset(path: str, name: str, data) -> None:
    """Create (or overwrite) a dataset, creating parent groups as needed."""
    _backend().write_dataset(path, name, data)


def list_group(path: str, group: str) -> list[str]:
    """Member names of an HDF5 group."""
    return _backend().list_group(path, group)


def dataset_shape(path: str, name: str) -> tuple[int, ...]:
    return _backend().dataset_shape(path, name)
