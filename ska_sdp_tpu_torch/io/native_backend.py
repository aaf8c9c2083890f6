"""ctypes bindings over the native HDF5 library (``io/native/``; port of
``ska_sdp_tpu/io/native_backend.py``).

The same functions as :mod:`.h5py_backend`, so the two are interchangeable
behind the :mod:`.h5` façade, and the files of either read in the other.
Unlike the reference's bindings this one needs no h5py at all: the stored
type of a dataset read without a ``dtype`` and the overwrite of an existing
dataset are native too.  The library is built at first use (``native/
build.py``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

_KF64, _KC128, _KI64, _KF32, _KI32, _KC64 = 0, 1, 2, 3, 4, 5
_KCI32 = 6  # {r, i} int32 compound: no numpy scalar type, read and
            # written as COMPLEX_INT_DTYPE

_KIND_BY_DTYPE = {
    np.dtype(np.float64): _KF64,
    np.dtype(np.complex128): _KC128,
    np.dtype(np.int64): _KI64,
    np.dtype(np.float32): _KF32,
    np.dtype(np.int32): _KI32,
    np.dtype(np.complex64): _KC64,
}

# numpy view of the {r, i} int32 compound (h5py reads it as this dtype)
COMPLEX_INT_DTYPE = np.dtype([("r", np.int32), ("i", np.int32)])
_DTYPE_BY_KIND = {**{v: k for k, v in _KIND_BY_DTYPE.items()},
                  _KCI32: COMPLEX_INT_DTYPE}

_c, _i, _ll = ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong
_vp = ctypes.c_void_p
_SIGNATURES = {
    "ska_h5_create": [_c],
    "ska_h5_kind": [_c, _c],
    "ska_h5_dims": [_c, _c, ctypes.POINTER(_ll)],
    "ska_h5_read": [_c, _c, _i, _vp],
    "ska_h5_read_stacked": [_c, _c, _i, _i, _ll, _vp],
    "ska_h5_read_slice": [_c, _c, _i, _ll, _ll, _vp],
    "ska_h5_write": [_c, _c, _i, _i, ctypes.POINTER(_ll), _vp],
    "ska_h5_list_group": [_c, _c, _c, _ll],
}


@functools.lru_cache(maxsize=1)
def ensure_loaded() -> ctypes.CDLL:
    """Build (if needed) and load the native library, its entry points
    bound with their signatures; raises as ``native.build.build`` does."""
    from .native import build

    lib = ctypes.CDLL(build.build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def create_file(path: str) -> None:
    if ensure_loaded().ska_h5_create(path.encode()) != 0:
        raise OSError(f"ska_h5_create failed for {path!r}")


def dataset_shape(path: str, name: str) -> tuple[int, ...]:
    dims = (ctypes.c_longlong * 16)()
    rank = ensure_loaded().ska_h5_dims(path.encode(), name.encode(), dims)
    if rank < 0:
        raise OSError(f"dataset {name!r} not found in {path!r}")
    return tuple(int(dims[i]) for i in range(rank))


def stored_dtype(path: str, name: str) -> np.dtype:
    """The dtype a dataset reads as at its stored width (float32 data as
    float32, a {r, i} float64 compound as complex128, ...)."""
    kind = ensure_loaded().ska_h5_kind(path.encode(), name.encode())
    if kind == -1:
        raise OSError(f"dataset {name!r} not found in {path!r}")
    if kind not in _DTYPE_BY_KIND:
        raise TypeError(f"dataset {name!r} in {path!r} has a stored type "
                        "the native layer does not read")
    return _DTYPE_BY_KIND[kind]


def _kind_of(dt: np.dtype) -> int:
    if dt == COMPLEX_INT_DTYPE:
        return _KCI32
    return _KIND_BY_DTYPE[dt]


def read_dataset(path: str, name: str, dtype=None) -> np.ndarray:
    """A whole dataset as ``dtype`` (HDF5 converts), by default its stored
    dtype."""
    shape = dataset_shape(path, name)
    dt = stored_dtype(path, name) if dtype is None else np.dtype(dtype)
    out = np.empty(shape, dtype=dt)
    rc = ensure_loaded().ska_h5_read(path.encode(), name.encode(),
                                     _kind_of(dt),
                                     out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise OSError(f"ska_h5_read({name!r}) failed rc={rc}")
    return out


def read_dataset_slice(path: str, name: str, start: int, count: int,
                       dtype=None) -> np.ndarray:
    """Rows ``[start, start + count)`` along the leading axis, read through
    a hyperslab selection."""
    shape = dataset_shape(path, name)
    dt = stored_dtype(path, name) if dtype is None else np.dtype(dtype)
    out = np.empty((count,) + shape[1:], dtype=dt)
    rc = ensure_loaded().ska_h5_read_slice(
        path.encode(), name.encode(), _kind_of(dt), start, count,
        out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise OSError(
            f"ska_h5_read_slice({name!r}, {start}, {count}) failed rc={rc}")
    return out


def read_datasets_stacked(path: str, names, dtype=None) -> np.ndarray:
    """Same-shape datasets stacked on a new leading axis."""
    names = [str(n) for n in names]
    shape = dataset_shape(path, names[0])
    dt = stored_dtype(path, names[0]) if dtype is None else np.dtype(dtype)
    elems = int(np.prod(shape)) if shape else 1
    out = np.empty((len(names),) + shape, dtype=dt)
    rc = ensure_loaded().ska_h5_read_stacked(
        path.encode(), "\n".join(names).encode(), len(names), _kind_of(dt),
        elems, out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise OSError(f"ska_h5_read_stacked failed rc={rc}")
    return out


def write_dataset(path: str, name: str, data: np.ndarray) -> None:
    """Create (or overwrite) a dataset, creating parent groups as needed;
    other float, complex and integer dtypes are widened to 64 bits."""
    data = np.ascontiguousarray(data)
    if data.dtype not in _KIND_BY_DTYPE and data.dtype != COMPLEX_INT_DTYPE:
        if data.dtype.kind == "f":
            data = data.astype(np.float64)
        elif data.dtype.kind == "c":
            data = data.astype(np.complex128)
        elif data.dtype.kind in "iu":
            data = data.astype(np.int64)
        else:
            raise TypeError(f"unsupported dtype {data.dtype}")
    dims = (ctypes.c_longlong * max(1, data.ndim))(*data.shape)
    rc = ensure_loaded().ska_h5_write(
        path.encode(), name.encode(), _kind_of(data.dtype), data.ndim, dims,
        data.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise OSError(f"ska_h5_write({name!r}) failed rc={rc}")


def list_group(path: str, group: str) -> list[str]:
    buf = ctypes.create_string_buffer(1 << 20)
    n = ensure_loaded().ska_h5_list_group(path.encode(), group.encode(), buf,
                                          len(buf))
    if n < 0:
        raise OSError(f"ska_h5_list_group({group!r}) failed rc={n}")
    if n == 0:
        return []
    return buf.value.decode().split("\n")
