"""Fused AW-projection gridding: the record semantics and spectral tables
of the TPU kernels, the wrapper of the CUDA kernel ``csrc/aw_grid.cu``,
its plain version and the dispatch ``aw_gridder`` (port of
``_pack_records`` and the tables of ``convgrid_aw_resident`` in
``ska_sdp_tpu/kernels/aw_fused_resident_pallas.py``, and of
``aw_gridder`` in ``ska_sdp_tpu/kernels/__init__.py``).

The kernel replaces ``aw_fused_resident_pallas.py::_kernel``, and the
tiled ``aw_fused_pallas.py::_kernel`` and the slab placement
``patch_scatter_pallas.py::_kernel`` fold into it: those exist because the
grid or the nant² pair table does not fit in VMEM, while the H100 keeps
both in device memory.

A record is ``(y0, x0, pid, kidx)``:

    y0 = y − s//2,  x0 = x − s//2           (from ``frac_coords``)
    pid = a1·nant + a2, clamped to [0, nant² − 1]
    kidx = (wbin·qpx + yf)·qpx + xf, clamped to [0, nk − 1]
    valid = (y0 > −s) & (y0 < H) & (x0 > −s) & (x0 < W)

and adds ``vis · conj(S · (P[pid] ⊙ Ŵ[kidx]) · Sᵀ)`` at ``(y0, x0)`` for
its in-bounds cells, with the raw tables

    P = T · (Â[a1] ⊙ Â[a2]) · Tᵀ    [npair, m, m]
    Ŵ = the w-tap spectra            [nw·qpx², m, m]

with ``T = _analysis_mat(s, m) @ _synthesis_mat(s, m)`` and ``S =
_synthesis_mat(s, m)``.  An invalid record has no cell inside
the grid and adds 0.  ``S · X · Sᵀ`` is m² times the forward 2-D DFT of
``X`` at the bins ``(i − s//2) mod m`` (:func:`synthesis_fft`), which is
how the kernel computes it.  On the card the pair table is built only for
the pairs that occur: ``pid`` is remapped on the device with
``torch.unique``, which halves the table and its build at 512 stations
(130,816 of 262,144 pairs).  The kernel's call then drops the invalid
records and sorts the rest by pair on the card (:func:`aw_pair_plan` is
the same plan in PyTorch), so that it reads each pair row once per run of
a pair instead of once per record.  The TPU's packing (f32-encoded
fields, (8, 128) table rows, interleaved lanes, padded grid) and its
precision tiers are not carried over: the kernel computes in complex64
with f32 sums, the reference's ``exact`` tier.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops.convolution import (_sandwich, _synthesis_mat, akernel_spectra,
                               pair_transfer, wkernel_tap_spectra)
from ..ops.coords import frac_coords
from ..ops.fourier import next_pow2
from ..ops.gridding import DEFAULT_CHUNK, _patch_cells, convgrid_aw
from ..utils.timing import launch_counters, launched, span
from ._build import bind
from ._plan import binned_items

GRID_KERNEL = "aw_grid"
MAX_SUPPORT = 32      # the kernel's envelope: m = next_pow2(2s − 1) ≤ 64
WINDOW = 32           # sorted records a warp of the kernel takes
# launches of the CUDA kernel since the last reset, and the reset
launch_count, reset_launch_count = launch_counters(GRID_KERNEL)


class AWRecords(NamedTuple):
    y0: torch.Tensor       # [n] int32 top-left row of the patch
    x0: torch.Tensor       # [n] int32 top-left column
    pid: torch.Tensor      # [n] int32 pair-table row
    kidx: torch.Tensor     # [n] int32 w-tap row
    valid: torch.Tensor    # [n] bool: some cell of the patch is in the grid
    support: int           # s


def aw_records(grid_shape, qpx: int, s: int, nant: int, nk: int,
               p: torch.Tensor, wbin: torch.Tensor, a1: torch.Tensor,
               a2: torch.Tensor) -> AWRecords:
    """The records of scaled baselines ``p`` ``[n, 3]``, w-planes ``wbin``
    and antennas ``a1``, ``a2`` on a ``grid_shape`` grid."""
    H, W = grid_shape
    x, xf, y, yf = frac_coords((H, W), qpx, p)
    y0 = y - s // 2
    x0 = x - s // 2
    valid = (y0 > -s) & (y0 < H) & (x0 > -s) & (x0 < W)
    i32 = torch.int32
    pid = torch.clamp(a1.to(i32) * nant + a2.to(i32), 0, nant * nant - 1)
    kidx = torch.clamp((wbin.to(i32) * qpx + yf) * qpx + xf, 0, nk - 1)
    return AWRecords(y0, x0, pid, kidx, valid, s)


def aw_tables(wkerns: torch.Tensor, akerns: torch.Tensor, pairs=None):
    """``(pair_tab [npair, m, m], w_spec [nw·qpx², m, m])``: the raw pair
    rows of the flat pair ids ``pairs`` (``a1·nant + a2``; every pair when
    None) and the w-tap spectra, in the complex type of the kernels."""
    nant, s = akerns.shape[0], akerns.shape[-1]
    a_spec = akernel_spectra(akerns)
    m = a_spec.shape[-1]
    if pairs is None:
        pairs = torch.arange(nant * nant, device=a_spec.device)
    pairs = pairs.long()
    prod = a_spec[pairs // nant] * a_spec[pairs % nant]
    pair_tab = _sandwich(pair_transfer(s, m), prod)
    w_spec = wkernel_tap_spectra(wkerns).reshape(-1, m, m)
    return pair_tab, w_spec


def aw_fused_plain(pair_tab: torch.Tensor, w_spec: torch.Tensor,
                   records: AWRecords, vis: torch.Tensor, grid_shape,
                   chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the ``grid_shape`` grid of
    ``vis`` placed through the records and tables, in chunks (gather, the
    product, the conjugated synthesis sandwich, the visibility multiply,
    ``index_add_`` of the in-bounds cells)."""
    H, W = grid_shape
    s = records.support
    m = pair_tab.shape[-1]
    dtype = torch.promote_types(pair_tab.dtype, vis.dtype)
    S = torch.as_tensor(_synthesis_mat(s, m), device=vis.device).to(dtype)
    out = torch.zeros((H, W), dtype=dtype, device=vis.device)
    flat = torch.view_as_real(out).view(-1, 2)
    for c0 in range(0, vis.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        idx, inb = _patch_cells(records.y0[sl], records.x0[sl], s, s, H, W)
        X = pair_tab[records.pid[sl].long()] * w_spec[records.kidx[sl].long()]
        aw = torch.matmul(torch.matmul(S, X.to(dtype)), S.transpose(0, 1))
        patch = torch.where(inb, vis[sl, None, None] * aw.conj(), 0)
        flat.index_add_(0, idx.reshape(-1),
                        torch.view_as_real(patch.to(dtype)).reshape(-1, 2))
    return out


def synthesis_fft(X: torch.Tensor, s: int) -> torch.Tensor:
    """``S · X · Sᵀ`` with ``S = _synthesis_mat(s, m)`` for spectra ``X``
    ``[..., m, m]``, as the kernel computes it: m² times the forward 2-D
    DFT of ``X`` at the bins ``(i − s//2) mod m``, ``i < s``."""
    m = X.shape[-1]
    r = (torch.arange(s, device=X.device) - s // 2) % m
    return torch.fft.fft2(X)[..., r[:, None], r[None, :]] * (m * m)


def aw_pair_plan(records: AWRecords, grid_shape, npair: int,
                 window: int = WINDOW):
    """The kernel's work, as it builds it on the card: ``(order, items)``
    of :func:`_plan.binned_items` with the records' pair rows (``pid``
    clamped to ``[0, npair − 1]``) as bins and the invalid records (no cell
    inside the ``grid_shape`` grid) in none.  ``order`` lists the valid
    records by pair, in input order within a pair; each item is (pair row,
    first, end): a run of one pair inside a warp's window."""
    H, W = grid_shape
    s = records.support
    y0, x0 = records.y0, records.x0
    valid = (y0 > -s) & (y0 < H) & (x0 > -s) & (x0 < W)
    pid = records.pid.to(torch.int32).clamp(0, npair - 1)
    return binned_items(torch.where(valid, pid, npair), npair, window)


def _check(pair_tab, w_spec, records, vis, grid):
    """The kernel takes complex64 data, ``[rows, m, m]`` tables and every
    input on one device."""
    dev = vis.device
    for t in (pair_tab, w_spec, records.y0, records.x0, records.pid,
              records.kidx, grid):
        if t.device != dev:
            raise ValueError("all kernel inputs must be on one device")
    for t in (pair_tab, w_spec, vis, grid):
        if t.dtype != torch.complex64:
            raise ValueError(
                "the CUDA AW gridder computes in complex64 (got "
                f"{t.dtype}); precision 'double' runs on the CPU")
    if records.support > MAX_SUPPORT:
        raise NotImplementedError(
            f"AW support s={records.support} is outside the CUDA gridder's "
            f"envelope (s ≤ {MAX_SUPPORT}, m = next_pow2(2s − 1) ≤ 64)")
    m = next_pow2(2 * records.support - 1)
    if (pair_tab.dim() != 3 or w_spec.dim() != 3
            or pair_tab.shape[1:] != (m, m) or w_spec.shape[1:] != (m, m)):
        raise ValueError(f"tables must be [rows, {m}, {m}] for support "
                         f"{records.support}")


@functools.lru_cache(maxsize=64)
def _scratch_bytes(n: int, npair: int) -> int:
    """Bytes of scratch ``csrc/aw_grid.cu`` needs (its keys and sort)."""
    size, _ = bind(GRID_KERNEL, "aw_grid_scratch_bytes",
                   [ctypes.c_longlong, ctypes.c_int], ctypes.c_longlong)
    return max(size(n, npair), 1)


def _launch(pair_tab, w_spec, records: AWRecords, vis, grid, n_valid=None):
    """Launch ``csrc/aw_grid.cu`` on the current stream (its keys, its sort
    of the records by pair and the gridder, with scratch from here),
    accumulating into ``grid`` (and the count of placed records into the
    int32 ``n_valid`` when given); raises on a refused launch."""
    s, m = records.support, pair_tab.shape[-1]
    H, W = grid.shape
    npair = pair_tab.shape[0]
    # a lazily conjugated view would hand the kernel the unconjugated data
    pair_tab = pair_tab.resolve_conj().contiguous()
    w_spec = w_spec.resolve_conj().contiguous()
    vis = vis.resolve_conj().contiguous()
    recs = torch.stack([records.y0, records.x0, records.pid,
                        records.kidx]).to(torch.int32).contiguous()
    for t in (pair_tab, w_spec):
        if t.data_ptr() % 16:
            raise ValueError("tables must be 16-byte aligned")
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn, err = bind(GRID_KERNEL, GRID_KERNEL,
                   [vp, ci, vp, ci, ci, ci, vp, vp, cll, vp, cll, vp, ci, ci,
                    vp, vp])
    n = recs.shape[1]
    scratch = torch.empty(_scratch_bytes(n, npair), dtype=torch.uint8,
                          device=vis.device)
    dev = vis.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(pair_tab.data_ptr(), npair, w_spec.data_ptr(),
                w_spec.shape[0], s, m, recs.data_ptr(), vis.data_ptr(), n,
                scratch.data_ptr(), scratch.numel(), grid.data_ptr(), H, W,
                None if n_valid is None else n_valid.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{GRID_KERNEL} launch failed: "
                           f"{err(rc).decode()} ({rc})")
    launched(GRID_KERNEL)
    return grid


def aw_fused_grid(pair_tab: torch.Tensor, w_spec: torch.Tensor,
                  records: AWRecords, vis: torch.Tensor, grid_shape,
                  init=None, n_valid=None) -> torch.Tensor:
    """The ``grid_shape`` grid of ``vis`` placed through the records and
    raw tables, added to ``init`` (left unchanged) when given.  CUDA
    tensors launch ``csrc/aw_grid.cu`` (float2 atomics into a zero grid or
    a copy of ``init``), which adds the count of records it placed to the
    one-element int32 CUDA tensor ``n_valid`` when given; CPU tensors take
    :func:`aw_fused_plain`."""
    with span("sdp.kernel.aw_grid"):
        if vis.is_cuda:
            out = (torch.zeros(grid_shape, dtype=torch.complex64,
                               device=vis.device) if init is None
                   else init.resolve_conj().clone(
                       memory_format=torch.contiguous_format))
            _check(pair_tab, w_spec, records, vis, out)
            if n_valid is not None and (n_valid.dtype != torch.int32
                                        or n_valid.device != vis.device
                                        or n_valid.numel() != 1):
                raise ValueError("n_valid must be one int32 on the kernel's "
                                 "device")
            return _launch(pair_tab, w_spec, records, vis, out, n_valid)
        if vis.device.type == "cpu":
            out = aw_fused_plain(pair_tab, w_spec, records, vis, grid_shape)
            return out if init is None else init + out
    raise ValueError(f"no AW gridder for device {vis.device}")


def aw_records_tables(wkerns: torch.Tensor, akerns: torch.Tensor,
                      grid_shape, p: torch.Tensor, wbin: torch.Tensor,
                      a1: torch.Tensor, a2: torch.Tensor):
    """``(records, pair_tab, w_spec)`` as the card's route builds them:
    the records with ``pid`` remapped on the device (``torch.unique``) to
    the rows of a pair table over the pairs that occur."""
    nw, qpx, _, s, _ = wkerns.shape
    rec = aw_records(grid_shape, qpx, s, akerns.shape[0], nw * qpx * qpx, p,
                     wbin, a1, a2)
    pairs, pid = torch.unique(rec.pid, return_inverse=True)
    pair_tab, w_spec = aw_tables(wkerns, akerns, pairs)
    return rec._replace(pid=pid.to(torch.int32)), pair_tab, w_spec


def aw_gridder(wkerns: torch.Tensor, akerns: torch.Tensor, guv: torch.Tensor,
               p: torch.Tensor, wbin: torch.Tensor, a1: torch.Tensor,
               a2: torch.Tensor, vis: torch.Tensor,
               chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """AW-projection gridding with on-the-fly ``conj(A1 ⊛ A2 ⊛ W)``
    kernels: ``guv`` plus the scatter of ``vis`` at scaled baselines ``p``
    ``[n, 3]`` with w-planes ``wbin`` and antennas ``a1``, ``a2``, through
    the unconjugated bank ``wkerns`` ``[nw, qpx, qpx, s, s]`` and the
    A-kernels ``akerns`` ``[nant, s, s]`` (the reference's ``aw_gridder``
    without its ``slab``).

    CUDA tensors: :func:`aw_records_tables` on the card, then
    ``csrc/aw_grid.cu`` (s ≤ 32; larger supports raise
    ``NotImplementedError``).  CPU tensors:
    :func:`ops.gridding.convgrid_aw` in chunks of ``chunk``, the route the
    reference takes off the TPU."""
    if vis.is_cuda:
        with span("sdp.device_prep"):
            rec, pair_tab, w_spec = aw_records_tables(
                wkerns, akerns, tuple(guv.shape), p, wbin, a1, a2)
        return aw_fused_grid(pair_tab, w_spec, rec, vis, tuple(guv.shape),
                             init=guv)
    if vis.device.type == "cpu":
        return convgrid_aw(wkerns, akerns, guv, p, wbin, a1, a2, vis,
                           chunk=chunk)
    raise ValueError(f"no AW gridder for device {vis.device}")
