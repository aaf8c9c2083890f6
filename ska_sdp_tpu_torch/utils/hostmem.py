"""The host side of the copies to and from the card: :func:`to_device`,
the one path of a caller's array to the card, and :class:`HostCopy`.

An array a caller hands to an entry on every call (a major cycle's uvw
and antenna ids, a snapshot's visibilities) is copied to the card from
page-locked memory, asynchronously, in its own dtype: :func:`pinned_copy`
(the cast to the entry's dtype is the caller's, on the card).
:class:`HostRegistry` page-locks the caller's own memory in place
(``cudaHostRegister``) the second time it sees it, so an array seen once,
as a freshly read file or a fresh residual is, is never registered and
keeps the pageable path.

A buffer is the outermost ndarray of an array's ``.base`` chain, with its
byte range: a view (``uvw[lo:hi]``, ``antenna1[:n]``) hits its buffer's
registration.  A registered buffer is unregistered before its owner frees
it (``weakref.finalize``), or, least recently used first, when another
registration would take the registered bytes above
:attr:`HostRegistry.bound`, a quarter of the machine's physical memory.
A registration that fails leaves its buffer on the pageable path for good.
Registrations run in the host-only span ``sdp.host_prep.register`` and
count in :data:`timing.COUNTERS` as ``h2d/register`` and
``h2d/register_failed``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import weakref
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .timing import COUNTERS, add, span

# the numpy dtypes of the entries' inputs, and torch's names for them
TORCH_DTYPE = {np.dtype(k): v for k, v in (
    (np.float64, torch.float64), (np.float32, torch.float32),
    (np.complex128, torch.complex128), (np.complex64, torch.complex64),
    (np.int64, torch.int64), (np.int32, torch.int32))}
# a strided view is copied through its span of the buffer where the span
# holds at most this many times its bytes: a registered copy with the cast
# on the card moved SKA1-Low's 25 MB uvw 8.6 times as fast as the host's
# cast and pageable copy (0.55 against 4.70 ms, H100 80GB HBM3, 700 W)
_SPAN_RATIO = 8
_SEEN, _FAILED, _PINNED = "seen", "failed", "pinned"


@functools.lru_cache(maxsize=None)
def _cudart() -> Optional[ctypes.CDLL]:
    """The CUDA runtime library PyTorch loaded, bound with ctypes, or None
    where this process has none in its memory map."""
    torch.cuda.init()
    try:
        with open("/proc/self/maps") as f:
            paths = sorted({ln.split()[-1] for ln in f
                            if "/libcudart.so" in ln})
    except OSError:
        return None
    if not paths:
        return None
    lib = ctypes.CDLL(paths[0])
    lib.cudaHostRegister.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                     ctypes.c_uint]
    lib.cudaHostUnregister.argtypes = [ctypes.c_void_p]
    for fn in (lib.cudaHostRegister, lib.cudaHostUnregister,
               lib.cudaGetLastError):
        fn.restype = ctypes.c_int
    return lib


def _cuda_register(ptr: int, size: int) -> bool:
    """``cudaHostRegister`` (portable) of ``size`` bytes at ``ptr``.  A
    failed call's error is read back at once: left, it would fail the next
    kernel launch's check."""
    lib = _cudart()
    if lib is None:
        return False
    if lib.cudaHostRegister(ptr, size, 1) != 0:
        lib.cudaGetLastError()
        return False
    return True


def _cuda_unregister(ptr: int) -> None:
    """``cudaHostUnregister`` once the card has read what it was given."""
    lib = _cudart()
    torch.cuda.synchronize()
    if lib.cudaHostUnregister(ptr) != 0:
        lib.cudaGetLastError()


def _bounds(a: np.ndarray) -> Tuple[int, int]:
    """The byte range ``[lo, hi)`` that ``a``'s elements span."""
    lo = hi = a.ctypes.data
    for n, s in zip(a.shape, a.strides):
        if n == 0:
            return lo, lo
        if s < 0:
            lo += (n - 1) * s
        else:
            hi += (n - 1) * s
    return lo, hi + a.itemsize


class HostRegistry:
    """The host buffers registered as page-locked, in least recently used
    order.  ``register(ptr, size) -> bool`` and ``unregister(ptr)`` are the
    CUDA runtime's unless given; ``bound`` caps the registered bytes (a
    quarter of physical memory unless given)."""

    def __init__(self, register: Optional[Callable[[int, int], bool]] = None,
                 unregister: Optional[Callable[[int], None]] = None,
                 bound: Optional[int] = None):
        self._register = register or _cuda_register
        self._unregister = unregister or _cuda_unregister
        self.bound = (os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
                      // 4 if bound is None else bound)
        self.bytes = 0                         # registered now
        self._state: dict = {}                 # buffer key → state
        self._lru: collections.OrderedDict = collections.OrderedDict()

    def pinned(self, x: np.ndarray, lo: int, hi: int) -> bool:
        """Whether the bytes ``[lo, hi)`` of ``x`` lie in a registered
        buffer: ``x``'s buffer is registered on its second sight here, or
        was before."""
        base = x
        while isinstance(base.base, np.ndarray):
            base = base.base
        blo, bhi = _bounds(base)
        if not blo <= lo < hi <= bhi:
            return False
        key = (id(base), blo, bhi)
        state = self._state.get(key)
        if state is _PINNED:
            self._lru.move_to_end(key)
            return True
        if state is None:
            self._state[key] = _SEEN
            weakref.finalize(base, self._forget, key).atexit = False
            return False
        if state is _FAILED or bhi - blo > self.bound:
            return False
        return self._pin(key, blo, bhi - blo)

    def _pin(self, key, ptr: int, size: int) -> bool:
        while self._lru and self.bytes + size > self.bound:
            old, held = self._lru.popitem(last=False)
            self._state[old] = _SEEN
            self._release(held)
        with span("sdp.host_prep.register", host_only=True):
            ok = self._register(ptr, size)
        if not ok:
            COUNTERS.add("h2d/register_failed")
            self._state[key] = _FAILED
            return False
        COUNTERS.add("h2d/register")
        self._state[key] = _PINNED
        self._lru[key] = (ptr, size)
        self.bytes += size
        return True

    def _release(self, held) -> None:
        ptr, size = held
        self.bytes -= size
        self._unregister(ptr)

    def _forget(self, key) -> None:
        """The buffer's owner is being freed: unregister it first."""
        self._state.pop(key, None)
        held = self._lru.pop(key, None)
        if held is not None:
            self._release(held)


REGISTRY = HostRegistry()


def pinned_copy(x, device) -> Optional[Tuple[torch.Tensor, int]]:
    """``(tensor, bytes copied)``: the array ``x`` on the CUDA ``device`` in
    its own dtype, C-contiguous, copied asynchronously from its registered
    buffer (:data:`REGISTRY`); a strided view through its span of the
    buffer, then taken apart on the card.  None where ``x`` is no
    non-empty numpy array of a dtype in :data:`TORCH_DTYPE`, has a
    negative or odd stride, spans more than ``_SPAN_RATIO`` times its
    bytes, or its buffer is not registered: the caller copies it the
    pageable way.  The card has read ``x`` once the device's stream has
    passed the copy."""
    if not (isinstance(x, np.ndarray) and x.size and x.dtype in TORCH_DTYPE):
        return None
    item = x.itemsize
    if any(s < 0 or s % item for s in x.strides):
        return None
    lo, hi = _bounds(x)
    count = (hi - lo) // item
    if count > _SPAN_RATIO * x.size or not REGISTRY.pinned(x, lo, hi):
        return None
    if x.flags.c_contiguous:
        return torch.from_numpy(x).to(device, non_blocking=True), hi - lo
    run = np.lib.stride_tricks.as_strided(x, (count,), (item,))
    t = torch.from_numpy(run).to(device, non_blocking=True)
    return (t.as_strided(x.shape, [s // item for s in x.strides])
            .contiguous(), hi - lo)


def to_device(x, device, *, np_dtype=None, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)`` after the host
    cast ``np.ascontiguousarray(x, np_dtype)`` when ``np_dtype`` is given,
    bit for bit.  On a CUDA device a numpy array whose buffer is
    registered as page-locked (:data:`REGISTRY`: handed over before) is
    copied asynchronously in its own dtype and cast on the card; the
    entries' readbacks wait for the copy.  Anything else takes the host
    cast (span ``sdp.host_prep.cast``) and a pageable copy.  The bytes
    copied from host memory to a card count in the open spans'
    ``h2d_bytes``, those from registered memory also in
    ``h2d_registered_bytes``; a tensor already on a card, or one that
    stays on the host, counts 0.  ``timing.COUNTERS`` counts the copies
    ``h2d/registered`` and ``h2d/pageable``."""
    got = (pinned_copy(x, device)
           if torch.device(device).type == "cuda" else None)
    if got is not None:
        t, nbytes = got
        add("h2d_bytes", nbytes)
        add("h2d_registered_bytes", nbytes)
        COUNTERS.add("h2d/registered")
        if np_dtype is not None:
            t = t.to(TORCH_DTYPE[np.dtype(np_dtype)])
        return t if dtype is None else t.to(dtype)
    if np_dtype is not None:
        with span("sdp.host_prep.cast", host_only=True):
            x = np.ascontiguousarray(x, np_dtype)
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if t.device.type != "cpu" and not (isinstance(x, torch.Tensor)
                                       and x.device.type != "cpu"):
        add("h2d_bytes", t.numel() * t.element_size())
        COUNTERS.add("h2d/pageable")
    return t


class HostCopy:
    """The host side of a slab callback: ``copy(grid)`` copies the grid
    into one host buffer reused from slab to slab, page-locked when the
    grid is on a CUDA device (a pageable copy of a 2400² grid runs at a
    fraction of the link's rate), and returns it as numpy.  The next copy
    overwrites it."""

    def __init__(self):
        self._buf: Optional[torch.Tensor] = None

    def __call__(self, grid: torch.Tensor) -> np.ndarray:
        buf = self._buf
        if buf is None or buf.shape != grid.shape or buf.dtype != grid.dtype:
            buf = self._buf = torch.empty(grid.shape, dtype=grid.dtype,
                                          pin_memory=grid.is_cuda)
        buf.copy_(grid)
        return buf.numpy()
