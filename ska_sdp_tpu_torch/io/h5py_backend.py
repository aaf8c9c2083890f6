"""h5py implementation of the HDF5 I/O functions (port of
``ska_sdp_tpu/io/h5py_backend.py``), one of the two backends behind the
:mod:`.h5` façade; the other is :mod:`.native_backend`."""

from __future__ import annotations

import os

import h5py
import numpy as np


def fix_ext(path: str) -> str:
    return path if path.endswith(".h5") else path + ".h5"


def create_file(path: str) -> None:
    with h5py.File(fix_ext(path), "w"):
        pass


def read_dataset(path: str, name: str, dtype=None) -> np.ndarray:
    with h5py.File(fix_ext(path), "r") as f:
        arr = np.asarray(f[name])
    return arr if dtype is None else arr.astype(dtype)


def read_datasets_stacked(path: str, names, dtype=None) -> np.ndarray:
    """Read same-shape datasets and stack them on a new leading axis."""
    with h5py.File(fix_ext(path), "r") as f:
        out = np.stack([np.asarray(f[n]) for n in names], axis=0)
    return out if dtype is None else out.astype(dtype)


def list_group(path: str, group: str) -> list[str]:
    """Member names of an HDF5 group."""
    with h5py.File(fix_ext(path), "r") as f:
        return list(f[group].keys())


def write_dataset(path: str, name: str, data: np.ndarray) -> None:
    """Create (or overwrite) a dataset, creating parent groups as needed."""
    path = fix_ext(path)
    mode = "a" if os.path.exists(path) else "w"
    with h5py.File(path, mode) as f:
        if name in f:
            del f[name]
        f.create_dataset(name, data=np.ascontiguousarray(data))


def read_dataset_slice(path: str, name: str, start: int, count: int,
                       dtype=None) -> np.ndarray:
    """Rows ``[start, start + count)`` of a dataset along its leading
    axis."""
    with h5py.File(fix_ext(path), "r") as f:
        arr = np.asarray(f[name][start:start + count])
    return arr if dtype is None else arr.astype(dtype)


def dataset_shape(path: str, name: str) -> tuple[int, ...]:
    with h5py.File(fix_ext(path), "r") as f:
        return tuple(f[name].shape)
