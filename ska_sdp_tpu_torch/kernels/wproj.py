"""Bank w-projection scatter and gather: the record semantics of the TPU
kernels and the wrappers of the CUDA kernels ``csrc/wproj_grid.cu`` and
``csrc/wproj_degrid.cu`` (port of ``wproj_resident_records`` of
``ska_sdp_tpu/kernels/wproj_resident_pallas.py``; the kernels replace
``wproj_resident_pallas.py::_kernel`` and
``wproj_degrid_resident_pallas.py::_kernel``, and the tiled
``wproj_pallas.py::_kernel`` and ``wproj_degrid_pallas.py::_kernel`` fold
into them because the grid lives in device memory).

A record is ``(y0, x0, kidx)``:

    y0 = y − gh//2,  x0 = x − gw//2                 (from ``frac_coords``)
    kidx = wbin·qpx² + yf·qpx + xf, clamped to [0, nk − 1]
    valid = (y0 > −gh) & (y0 < H) & (x0 > −gw) & (x0 < W)

An invalid record has no cell inside the grid and contributes 0 both
ways.  Both kernels build their records and sort them by ``TILE``×``TILE``
grid tile inside their call, on the card.  The scatter bins each valid
record into every output tile its in-grid cells touch
(:func:`wproj_tile_plan` is the same plan in PyTorch), so that its warps
accumulate a tile in shared memory and add it to the grid once per run.
The gather keys each valid record once, by the tile of its clamped
origin (:func:`wproj_gather_plan`), so that a block stages that tile's
grid region in shared memory once for the run of its records.  The TPU's
packing (f32-encoded fields, crop margins, interleaved
lanes) is not carried over.  The wrappers launch the kernels for CUDA
tensors and use the plain versions of ``ops/gridding.py`` only for CPU
tensors; they never fall back.  The kernels compute in complex64.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.coords import frac_coords
from ..ops.gridding import convgrid_wproj, degrid_wproj
from ._build import bind
from ._plan import binned_items

GRID_KERNEL = "wproj_grid"
DEGRID_KERNEL = "wproj_degrid"
TILE = 32           # the scatter's output tile, T×T cells (csrc kTile)
WINDOW = 256        # sorted (tile, record) entries a warp of the scatter takes
GATHER_WINDOW = 512     # sorted records a block of the gather takes
_launches = {GRID_KERNEL: 0, DEGRID_KERNEL: 0}


def launch_count(kernel: str = GRID_KERNEL) -> int:
    """Launches of a CUDA kernel (:data:`GRID_KERNEL` or
    :data:`DEGRID_KERNEL`) since the last reset."""
    return _launches[kernel]


def reset_launch_count() -> None:
    """Set every kernel's launch count to 0."""
    for k in _launches:
        _launches[k] = 0


def wproj_records(grid_shape, qpx: int, gh: int, gw: int, nk: int,
                  p: torch.Tensor, wbin: torch.Tensor):
    """``(y0, x0, kidx, valid)``: int32 placements and flat bank-plane
    indices of the records, and their ``[n]`` validity mask."""
    H, W = grid_shape
    x, xf, y, yf = frac_coords((H, W), qpx, p)
    y0 = y - gh // 2
    x0 = x - gw // 2
    valid = (y0 > -gh) & (y0 < H) & (x0 > -gw) & (x0 < W)
    kidx = torch.clamp(wbin.to(torch.int32) * (qpx * qpx) + yf * qpx + xf,
                       0, nk - 1)
    return y0, x0, kidx, valid


def wproj_tile_plan(y0, x0, gh: int, gw: int, grid_shape,
                    window: int = WINDOW):
    """The scatter's work, as it builds it on the card: ``(entries, items,
    ntx)``.  Each record has one slot for every ``TILE``×``TILE`` tile
    (row-major, ``ntx`` across) its patch may touch, ``(gh + TILE −
    2)//TILE + 1`` a side, binned to the tile where its cells inside the
    ``grid_shape`` grid touch it and to none elsewhere; ``entries`` lists
    the record of each slot by tile, in input order within a tile, the
    unbinned last, and ``items`` the (tile, first, end) runs of
    :func:`_plan.binned_items`."""
    H, W = grid_shape
    nty, ntx = -(-H // TILE), -(-W // TILE)
    valid = (y0 > -gh) & (y0 < H) & (x0 > -gw) & (x0 < W)
    spans = []
    for lo, size, n in ((y0, gh, H), (x0, gw, W)):
        first = lo.clamp(min=0) // TILE
        last = ((lo + size).clamp(max=n) - 1) // TILE
        t = first[:, None] + torch.arange((size + TILE - 2) // TILE + 1,
                                          device=lo.device, dtype=lo.dtype)
        spans.append((t, t <= last[:, None]))
    (ty, oky), (tx, okx) = spans
    ok = oky[:, :, None] & okx[:, None, :] & valid[:, None, None]
    key = torch.where(ok, ty[:, :, None] * ntx + tx[:, None, :], nty * ntx)
    order, items = binned_items(key.reshape(-1), nty * ntx, window)
    entries = (order // (ok.shape[1] * ok.shape[2])).to(torch.int32)
    return entries, items, ntx


def wproj_gather_plan(y0, x0, gh: int, gw: int, grid_shape,
                      window: int = GATHER_WINDOW):
    """The gather's work, as it builds it on the card: ``(order, items,
    ntx)``.  Each record has one key: the ``TILE``×``TILE`` tile
    (row-major, ``ntx`` across) of its origin clamped to the
    ``grid_shape`` grid if any of its cells lies inside the grid, else
    none; ``order`` lists the records by tile, in input order within a
    tile, those in no tile last, and ``items`` the (tile, first, end) runs
    of :func:`_plan.binned_items`, inside aligned windows of ``window``
    positions, one block's each."""
    H, W = grid_shape
    nty, ntx = -(-H // TILE), -(-W // TILE)
    valid = (y0 > -gh) & (y0 < H) & (x0 > -gw) & (x0 < W)
    key = torch.where(valid, (y0.clamp(min=0) // TILE) * ntx
                      + x0.clamp(min=0) // TILE, nty * ntx)
    order, items = binned_items(key, nty * ntx, window)
    return order, items, ntx


def _check(bank, grid, p, wbin, vis=None):
    """The kernels take every input on one device, complex64 data, a 5-d
    bank and a 2-d grid."""
    for t in (grid, p, wbin, vis):
        if t is not None and t.device != bank.device:
            raise ValueError("all kernel inputs must be on one device")
    for t in (bank, grid) if vis is None else (bank, grid, vis):
        if t.dtype != torch.complex64:
            raise ValueError(
                "the CUDA w-projection kernels compute in complex64 (got "
                f"{t.dtype}); precision 'double' runs on the CPU")
    if bank.dim() != 5 or grid.dim() != 2:
        raise ValueError("bank must be [nw, qpx, qpx, gh, gw] and the grid "
                         "[H, W]")


def _run(kernel: str, argtypes, *args) -> None:
    """Launch ``csrc/<kernel>.cu`` on the current stream of the first
    argument's device; raises on a refused launch."""
    fn, err = bind(kernel, kernel, argtypes)
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: {err(rc).decode()} "
                           f"({rc})")
    _launches[kernel] += 1


@functools.lru_cache(maxsize=64)
def _scratch_bytes(n: int, gh: int, gw: int, H: int, W: int) -> int:
    """Bytes of scratch ``csrc/wproj_grid.cu`` needs (its keys and sort)."""
    cll, ci = ctypes.c_longlong, ctypes.c_int
    size, _ = bind(GRID_KERNEL, "wproj_grid_scratch_bytes",
                   [cll, ci, ci, ci, ci], cll)
    return max(size(n, gh, gw, H, W), 1)


@functools.lru_cache(maxsize=64)
def _gather_scratch_bytes(n: int, H: int, W: int) -> int:
    """Bytes of scratch ``csrc/wproj_degrid.cu`` needs (its keys and
    sort)."""
    cll, ci = ctypes.c_longlong, ctypes.c_int
    size, _ = bind(DEGRID_KERNEL, "wproj_degrid_scratch_bytes",
                   [cll, ci, ci], cll)
    return max(size(n, H, W), 1)


def _check_p(p):
    if p.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"p must be float32 or float64 (got {p.dtype})")
    return p.contiguous()


def _launch_grid(bank, grid_shape, p, wbin, vis, grid):
    """Launch ``csrc/wproj_grid.cu`` (its records and keys, its sort of
    the records by tile and the scatter, with scratch from here), adding
    into ``grid``."""
    H, W = grid_shape
    nw, qpx, _, gh, gw = bank.shape
    # a lazily conjugated view would hand the kernel the unconjugated data
    bank = bank.resolve_conj().contiguous()
    p = _check_p(p)
    n = p.shape[0]
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    scratch = torch.empty(_scratch_bytes(n, gh, gw, H, W),
                          dtype=torch.uint8, device=grid.device)
    _run(GRID_KERNEL, [vp, ci, ci, ci, ci, vp, ci, vp, cll, vp, vp, cll, vp,
                       ci, ci, vp],
         bank, nw, qpx, gh, gw, p, int(p.dtype == torch.float64),
         wbin.to(torch.int32).contiguous(), n,
         vis.resolve_conj().contiguous(), scratch, scratch.numel(), grid, H,
         W)
    return grid


def _launch_degrid(bank, grid, p, wbin, out):
    """Launch ``csrc/wproj_degrid.cu`` (its records and keys, its sort of
    the records by tile and the gather, with scratch from here), writing
    every entry of ``out``."""
    H, W = grid.shape
    nw, qpx, _, gh, gw = bank.shape
    # a lazily conjugated view would hand the kernel the unconjugated data
    bank = bank.resolve_conj().contiguous()
    p = _check_p(p)
    n = p.shape[0]
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    scratch = torch.empty(_gather_scratch_bytes(n, H, W), dtype=torch.uint8,
                          device=grid.device)
    _run(DEGRID_KERNEL, [vp, ci, ci, ci, ci, vp, ci, vp, cll, vp, cll, vp,
                         ci, ci, vp, vp],
         bank, nw, qpx, gh, gw, p, int(p.dtype == torch.float64),
         wbin.to(torch.int32).contiguous(), n, scratch, scratch.numel(),
         grid.resolve_conj().contiguous(), H, W, out)
    return out


def wproj_gridder(bank_conj: torch.Tensor, grid_shape, p: torch.Tensor,
                  wbin: torch.Tensor, vis: torch.Tensor, chunk: int = 16384,
                  init=None) -> torch.Tensor:
    """The ``[H, W]`` uv-grid of ``vis`` scattered through the
    pre-conjugated bank ``[nw, qpx, qpx, gh, gw]`` at scaled baselines
    ``p`` ``[n, 3]`` and bank planes ``wbin`` ``[n]``, added to ``init``
    (left unchanged) when given.

    CUDA tensors launch ``csrc/wproj_grid.cu``, which bins the records by
    output tile (:func:`wproj_tile_plan`), sums each tile in shared memory
    and adds it with atomics into a zero grid or a copy of ``init``; CPU
    tensors take
    :func:`ops.gridding.convgrid_wproj` in chunks of ``chunk``.  One
    kernel serves every support."""
    if vis.is_cuda:
        out = (torch.zeros(grid_shape, dtype=torch.complex64,
                           device=vis.device) if init is None
               else init.resolve_conj().clone(
                   memory_format=torch.contiguous_format))
        _check(bank_conj, out, p, wbin, vis)
        return _launch_grid(bank_conj, grid_shape, p, wbin, vis, out)
    if vis.device.type == "cpu":
        guv = (torch.zeros(grid_shape, dtype=vis.dtype) if init is None
               else init)
        return convgrid_wproj(bank_conj, guv, p, wbin, vis, chunk=chunk)
    raise ValueError(f"no w-projection gridder for device {vis.device}")


def wproj_degridder(bank: torch.Tensor, grid: torch.Tensor, p: torch.Tensor,
                    wbin: torch.Tensor, chunk: int = 16384) -> torch.Tensor:
    """The ``[n]`` visibilities gathered from the ``[H, W]`` grid through
    the raw bank (conjugated inside): the adjoint of
    :func:`wproj_gridder` given the same bank.

    CUDA tensors launch ``csrc/wproj_degrid.cu``, which sorts the records
    by grid tile (:func:`wproj_gather_plan`) and gathers each tile's run
    from its region staged in shared memory (no atomics, the same result
    from run to run); CPU tensors take :func:`ops.gridding.degrid_wproj`
    in chunks of ``chunk``."""
    if grid.is_cuda:
        _check(bank, grid, p, wbin)
        out = torch.empty((p.shape[0],), dtype=torch.complex64,
                          device=grid.device)
        return _launch_degrid(bank, grid, p, wbin, out)
    if grid.device.type == "cpu":
        return degrid_wproj(bank, grid, p, wbin, chunk=chunk)
    raise ValueError(f"no w-projection degridder for device {grid.device}")
