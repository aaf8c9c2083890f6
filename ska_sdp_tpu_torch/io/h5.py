"""HDF5 reads and writes (port of ``ska_sdp_tpu/io/h5.py`` with its h5py
backend).  ``h5py`` is imported inside each function, so importing this
module needs no h5py; the reference's native C++ backend is not ported
yet."""

from __future__ import annotations

import os

import numpy as np


def fix_ext(path: str) -> str:
    return path if path.endswith(".h5") else path + ".h5"


def create_file(path: str) -> None:
    import h5py

    with h5py.File(fix_ext(path), "w"):
        pass


def read_dataset(path: str, name: str, dtype=None) -> np.ndarray:
    import h5py

    with h5py.File(fix_ext(path), "r") as f:
        arr = np.asarray(f[name])
    return arr if dtype is None else arr.astype(dtype)


def write_dataset(path: str, name: str, data: np.ndarray) -> None:
    """Create (or overwrite) a dataset, creating parent groups as needed."""
    import h5py

    path = fix_ext(path)
    mode = "a" if os.path.exists(path) else "w"
    with h5py.File(path, mode) as f:
        if name in f:
            del f[name]
        f.create_dataset(name, data=np.ascontiguousarray(data))
