"""Bank w-projection scatter and gather: the record semantics of the TPU
kernels and the wrappers of the CUDA kernels ``csrc/wproj_grid.cu`` and
``csrc/wproj_degrid.cu`` (port of ``wproj_resident_records`` of
``ska_sdp_tpu/kernels/wproj_resident_pallas.py``; the kernels replace
``wproj_resident_pallas.py::_kernel`` and
``wproj_degrid_resident_pallas.py::_kernel``, and the tiled
``wproj_pallas.py::_kernel`` and ``wproj_degrid_pallas.py::_kernel`` fold
into them because the grid lives in device memory).

A record is ``(y0, x0, kidx)`` in input order, no sort:

    y0 = y − gh//2,  x0 = x − gw//2                 (from ``frac_coords``)
    kidx = wbin·qpx² + yf·qpx + xf, clamped to [0, nk − 1]
    valid = (y0 > −gh) & (y0 < H) & (x0 > −gw) & (x0 < W)

An invalid record has no cell inside the grid and contributes 0 both
ways.  The TPU's packing (f32-encoded fields, crop margins, interleaved
lanes) is not carried over.  The wrappers launch the kernels for CUDA
tensors and use the plain versions of ``ops/gridding.py`` only for CPU
tensors; they never fall back.  The kernels compute in complex64.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.coords import frac_coords
from ..ops.gridding import convgrid_wproj, degrid_wproj
from ._build import bind

GRID_KERNEL = "wproj_grid"
DEGRID_KERNEL = "wproj_degrid"
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


def _launch(kernel: str, bank, grid_shape, p, wbin, src, dst):
    """Pack the records and launch ``csrc/<kernel>.cu`` on the current
    stream, reading ``src`` (visibilities or grid) and writing ``dst``;
    raises on a refused launch."""
    nw, qpx, _, gh, gw = bank.shape
    nk = nw * qpx * qpx
    H, W = grid_shape
    y0, x0, kidx, _ = wproj_records((H, W), qpx, gh, gw, nk, p, wbin)
    recs = torch.stack([y0, x0, kidx]).contiguous()
    # a lazily conjugated view would hand the kernel the unconjugated data
    bank = bank.resolve_conj().reshape(nk, gh, gw).contiguous()
    src = src.resolve_conj().contiguous()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn, err = bind(kernel, kernel, [vp, ci, ci, ci, vp, ctypes.c_longlong,
                                    vp, vp, ci, ci, vp])
    dev = bank.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(bank.data_ptr(), nk, gh, gw, recs.data_ptr(), recs.shape[1],
                src.data_ptr(), dst.data_ptr(), H, W, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: {err(rc).decode()} "
                           f"({rc})")
    _launches[kernel] += 1
    return dst


def wproj_gridder(bank_conj: torch.Tensor, grid_shape, p: torch.Tensor,
                  wbin: torch.Tensor, vis: torch.Tensor, chunk: int = 16384,
                  init=None) -> torch.Tensor:
    """The ``[H, W]`` uv-grid of ``vis`` scattered through the
    pre-conjugated bank ``[nw, qpx, qpx, gh, gw]`` at scaled baselines
    ``p`` ``[n, 3]`` and bank planes ``wbin`` ``[n]``, added to ``init``
    (left unchanged) when given.

    CUDA tensors launch ``csrc/wproj_grid.cu``, which accumulates with
    atomics into a zero grid or a copy of ``init``; CPU tensors take
    :func:`ops.gridding.convgrid_wproj` in chunks of ``chunk``.  One
    kernel serves every support."""
    if vis.is_cuda:
        out = (torch.zeros(grid_shape, dtype=torch.complex64,
                           device=vis.device) if init is None
               else init.resolve_conj().clone(
                   memory_format=torch.contiguous_format))
        _check(bank_conj, out, p, wbin, vis)
        return _launch(GRID_KERNEL, bank_conj, grid_shape, p, wbin, vis, out)
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

    CUDA tensors launch ``csrc/wproj_degrid.cu`` (one warp per record, no
    atomics, the same result from run to run); CPU tensors take
    :func:`ops.gridding.degrid_wproj` in chunks of ``chunk``."""
    if grid.is_cuda:
        _check(bank, grid, p, wbin)
        out = torch.empty((p.shape[0],), dtype=torch.complex64,
                          device=grid.device)
        return _launch(DEGRID_KERNEL, bank, grid.shape, p, wbin, grid, out)
    if grid.device.type == "cpu":
        return degrid_wproj(bank, grid, p, wbin, chunk=chunk)
    raise ValueError(f"no w-projection degridder for device {grid.device}")
