"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into a shared library at first use, then bound with
``ctypes``.  Libraries go to ``ska_sdp_tpu_torch/build/`` (git-ignored),
named by a hash of the source and of the headers beside it
(``csrc/*.cuh``), so an edited source or header is rebuilt.  No compiler
runs on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from ..utils.timing import span

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict[tuple[str, str], tuple] = {}
build_log: dict[str, str] = {}     # compiler output (ptxas resource use)


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels are built from csrc/ at first use")
    return found


def source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu`` and every ``csrc/*.cuh`` header, which
    names its library."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:12]


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and load it (cached), inside
    span ``sdp.build.<name>``."""
    if name in _loaded:
        return _loaded[name]
    with span(f"sdp.build.{name}", host_only=True):
        src = CSRC / f"{name}.cu"
        lib_path = BUILD_DIR / f"lib{name}_{source_digest(name)}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)],
                capture_output=True, text=True)
            build_log[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed for {src}:\n{build_log[name]}")
            os.replace(tmp, lib_path)     # atomic: concurrent builders agree
        lib = ctypes.CDLL(str(lib_path))
    _loaded[name] = lib
    return lib


def bind(name: str, entry: str, argtypes, restype=ctypes.c_int):
    """Build (if needed) and load ``csrc/<name>.cu``; returns the entry
    point with its ctypes signature (``restype``: by default ``int``, a
    ``cudaError_t``) and the library's ``<name>_error_string`` function.
    Bound once per entry point."""
    key = (name, entry)
    if key not in _bound:
        lib = load(name)
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = restype
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _bound[key] = fn, err
    return _bound[key]
