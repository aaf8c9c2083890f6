"""Find the HDF5 runtime and build the native HDF5 library against it.

``hdf5_native.cc`` is compiled by ``g++`` against the HDF5 *runtime*
library alone, through the ABI that ``h5_abi.h`` declares: HDF5 1.10,
whose sonames end in ``.103``.  :func:`find_hdf5` looks for such a soname
in the library directories (``LD_LIBRARY_PATH`` first) and reports what it
searched and any HDF5 runtime of another ABI it saw; it never links one of
those.  The library goes to ``build/`` beside the sources (git-ignored),
named by a hash of the sources and of the runtime it links, built at first
use and replaced atomically, so concurrent builders agree.
"""

from __future__ import annotations

import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple, Optional

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "build"
SOURCES = (_DIR / "hdf5_native.cc", _DIR / "h5_abi.h")

# the sonames of the ABI h5_abi.h declares (HDF5 1.10)
ABI_SONAMES = ("libhdf5_serial.so.103", "libhdf5.so.103")
LIB_DIRS = ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu",
            "/lib64", "/usr/lib64", "/lib", "/usr/lib", "/usr/local/lib")


class HDF5Runtime(NamedTuple):
    path: Optional[str]          # the runtime to link, or None
    searched: tuple[str, ...]    # every path looked at for ABI_SONAMES
    other_abi: tuple[str, ...]   # HDF5 runtimes of another ABI seen


def _lib_dirs() -> list[str]:
    env = [d for d in os.environ.get("LD_LIBRARY_PATH", "").split(":") if d]
    return list(dict.fromkeys(env + list(LIB_DIRS)))


@functools.lru_cache(maxsize=1)
def find_hdf5() -> HDF5Runtime:
    """The first HDF5 1.10 runtime in the library directories, by looking
    at the files there (nothing is loaded or linked)."""
    searched, other = [], []
    found = None
    for d in _lib_dirs():
        for so in ABI_SONAMES:
            cand = os.path.join(d, so)
            searched.append(cand)
            if found is None and os.path.exists(cand):
                found = cand
        if os.path.isdir(d):
            other += [str(p) for p in sorted(Path(d).glob("libhdf5*.so.*"))
                      if p.name.split(".so.")[0] in ("libhdf5",
                                                     "libhdf5_serial")
                      and not p.name.startswith(ABI_SONAMES)]
    return HDF5Runtime(found, tuple(searched), tuple(other))


def describe(rt: HDF5Runtime) -> str:
    """One line: what :func:`find_hdf5` found, or what it searched."""
    if rt.path is not None:
        return f"HDF5 runtime {rt.path} (the 1.10 ABI of h5_abi.h)"
    names = ", ".join(ABI_SONAMES)
    dirs = ", ".join(_lib_dirs())
    other = (f"; runtimes of another ABI, not linked: "
             f"{', '.join(rt.other_abi)}" if rt.other_abi else "")
    return f"no HDF5 runtime: searched {names} in {dirs}{other}"


def _digest(runtime: str) -> str:
    h = hashlib.sha256(runtime.encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:12]


def build() -> str:
    """Path of the native library, compiled first if its sources or the
    runtime changed.  Raises ``FileNotFoundError`` when there is no HDF5
    1.10 runtime (naming what was searched), ``RuntimeError`` when g++
    fails."""
    rt = find_hdf5()
    if rt.path is None:
        raise FileNotFoundError(describe(rt))
    lib_path = BUILD_DIR / f"libskah5_{_digest(rt.path)}.so"
    if lib_path.exists():
        return str(lib_path)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    libdir, soname = os.path.split(rt.path)
    proc = subprocess.run(
        ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", str(SOURCES[0]),
         "-o", tmp, f"-L{libdir}", f"-l:{soname}", f"-Wl,-rpath,{libdir}"],
        capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {SOURCES[0]} against {rt.path}:"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return str(lib_path)


if __name__ == "__main__":
    print(build())
