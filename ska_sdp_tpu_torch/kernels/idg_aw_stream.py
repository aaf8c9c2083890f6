"""Streamed IDG(-AW) gridder and degridder: wrappers of the CUDA kernels
``csrc/idg_grid.cu`` and ``csrc/idg_degrid.cu`` and their plain PyTorch
versions (port of ``ska_sdp_tpu/kernels/idg_aw_stream_pallas.py``:
``_dft_factors``, ``idg_aw_grid_from_records_stream``,
``idg_aw_grid_stream``, ``idg_aw_gridder_stream``, ``idg_aw_degrid_stream``
and ``idg_aw_degridder_stream``).

Gridding: per run of sorted records (one antenna pair, one uv tile) the
operator accumulates ``a[q, r] = Σ_b v_b·e_y[q, b]·e_x[r, b]`` on the S×S
subgrid image, multiplies by the conjugated pair screen
``conj(A[ia1]·A[ia2])``, applies the taper-folded DFT sandwich ``F·t·Fᵀ``
and adds the patch to the padded grid at the run's origin ``(y0, x0)``.
Degridding is its exact adjoint: the run's window ``W`` becomes
``I = (Fᴴ·W·conj(F)) ∘ (A[ia1]·A[ia2])`` and each record reads
``v_b = Σ_q Σ_r I[q, r]·conj(e_y[q, b]·e_x[r, b])``.  With unit screens
and zero pair ids both are plain continuous-w IDG.  Any even S from 2 to
128: the kernels serve S = 32, 64 and 128 with their own instances and
every other S on the instance of side :func:`padded_side` (S rounded up to
a multiple of 16), whose operands the wrappers zero-pad.

The wrappers launch the CUDA kernels for CUDA tensors and use the plain
versions only for CPU tensors; they never fall back.  The plain versions
compute in full float32, the reference's ``exact`` precision tier; both
CUDA kernels run their products on the tensor cores with split-fp16
operands scaled by powers of two (three fp16 passes into float32 sums, as
the reference's ``split3`` tier splits bf16), ~3e-7 of float64.  The
reference's
run-major kernels (``idg_aw_pallas.py::_kernel`` and
``idg_aw_degrid_pallas.py::_kernel``, selected by
``SKA_SDP_TPU_IDG_AW_KERNEL=run``) compute the same two operators, so the
port has no selector: both fold into this pair, and so do the fixed-tile
kernels (``idg_pallas.py::_kernel``, ``idg_degrid_pallas.py::_kernel``)
through the run table of ``kernels/idg_tile.py``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import numpy as np
import torch

from ..ops.idg import _dft_matrix, kaiser_taper
from ..ops.idg_aw import PAIR_SHIFT
from ..utils.timing import count_on_card, launch_counters, launched, span
from ._build import bind
from .idg_aw_records import idg_aw_degrid_records, idg_aw_run_records

GRID_KERNEL = "idg_grid_stream"
DEGRID_KERNEL = "idg_degrid_stream"
MAX_SUBGRID = 128        # the kernels' largest instance
# launches of a CUDA kernel since the last reset, and the reset
launch_count, reset_launch_count = launch_counters(GRID_KERNEL,
                                                   DEGRID_KERNEL)


def _dft_factor64(S: int, taper_beta: float, device=None):
    """The taper-folded DFT matrix ``F[y, q] = e^{−2πi k_y k_q / S}/S ·
    taper[q]`` (``k = i − S/2``) in complex128."""
    F = _dft_matrix(S, torch.complex128, device) / S
    if taper_beta > 0:
        F = F * kaiser_taper(S, taper_beta, torch.float64, device)[None, :]
    return F


@functools.lru_cache(maxsize=16)
def _dft_factors(S: int, taper_beta: float, device=None):
    """:func:`_dft_factor64` and its transpose as contiguous complex64;
    built once per (S, β, device), so callers only read them."""
    F = _dft_factor64(S, taper_beta, device).to(torch.complex64)
    return F, F.T.contiguous()


def _split_f16(x):
    """``(hi, lo)`` float16 planes of a float tensor: ``hi = fp16(x)``,
    ``lo = fp16(x − hi)``, so ``hi + lo`` holds ~22 bits of ``x``."""
    hi = x.to(torch.float16)
    return hi, (x - hi.to(x.dtype)).to(torch.float16)


def padded_side(S: int) -> int:
    """The side SP of the kernel instance that serves subgrid S: S rounded
    up to a multiple of 16.  Rows and columns from S on are zero in the
    padded operands (planes, screens) and in the kernels' phase factors."""
    return -(-S // 16) * 16


def check_subgrid(S: int) -> None:
    if S < 2 or S % 2 or S > MAX_SUBGRID:
        raise ValueError(f"subgrid {S}: the streamed kernels take an even "
                         f"subgrid from 2 to {MAX_SUBGRID}")


def _planes(M, S: int):
    """The split-fp16 planes ``[4, SP, SP]`` (re hi, re lo, im hi, im lo)
    of a complex ``[S, S]`` matrix, zero from S on (SP =
    :func:`padded_side`)."""
    SP = padded_side(S)
    P = torch.zeros((4, SP, SP), dtype=torch.float16, device=M.device)
    for k, x in enumerate((*_split_f16(M.real), *_split_f16(M.imag))):
        P[k, :S, :S] = x
    return P


@functools.lru_cache(maxsize=16)
def _dft_planes(S: int, taper_beta: float, device=None):
    """The split-fp16 planes ``[4, SP, SP]`` of ``16·S·F`` (|·| ≤ 16,
    where fp16 keeps its full precision) for ``csrc/idg_grid.cu``'s
    tensor-core sandwich, split from the float64 factor and zero-padded to
    the kernel's side (:func:`_planes`); built once per (S, β, device)."""
    return _planes(_dft_factor64(S, taper_beta, device) * (16 * S), S)


@functools.lru_cache(maxsize=16)
def _dft_planes_adjoint(S: int, taper_beta: float, device=None):
    """The split-fp16 planes ``[4, SP, SP]`` of ``16·S·Fᴴ`` (``Fᴴ[q, y] =
    conj(F[y, q])``) for ``csrc/idg_degrid.cu``'s sandwich ``Fᴴ·W·conj(F)``,
    which reads them as ``Fᴴ`` rows for its first product and as
    ``conj(F)`` columns for its second; zero-padded as :func:`_dft_planes`,
    built once per (S, β, device)."""
    return _planes(_dft_factor64(S, taper_beta, device).conj().T
                   * (16 * S), S)


def _padded_screens(screens, S: int):
    """``screens`` ``[nant, S, S]`` as the kernels read them: ``[nant, SP,
    SP]``, zero from S on (the same tensor where SP = S)."""
    SP = padded_side(S)
    if SP == S:
        return screens
    out = torch.zeros((screens.shape[0], SP, SP), dtype=screens.dtype,
                      device=screens.device)
    out[:, :S, :S] = screens
    return out


def length_class(n):
    """Run-length class of the gridder's block order: 0 for ``n ≤ 0``, else
    ``4·⌊log2 n⌋ + (the two bits of n below its leading one) + 1``, so
    classes are about 19% apart in length."""
    n = n.to(torch.int64)
    pos = n > 0
    m = torch.where(pos, n, torch.ones_like(n))
    e = torch.floor(torch.log2(m.to(torch.float64))).to(torch.int64)
    mant = torch.where(e >= 2, m >> torch.clamp(e - 2, min=0),
                       m << torch.clamp(2 - e, min=0)) & 3
    return torch.where(pos, 4 * e + mant + 1, torch.zeros_like(n))


def run_order(starts, ends):
    """Plain version of the gridder's block order (``csrc/idg_grid.cu``'s
    ``run_order_kernel``, which runs in the same launch): run-table indices
    by descending :func:`length_class`, int32.  Empty entries come last.
    Here ties keep table order; the kernel's counting sort leaves the order
    inside a class arbitrary.  The kernel orders work items
    (:func:`run_items`): it leaves the empty entries out and puts every
    item of a split run first, ahead of the runs of L records or fewer."""
    return torch.argsort(length_class(ends - starts), descending=True,
                         stable=True).to(torch.int32)


ITEM_FLOOR = 32          # records a subgrid side, the least item length
ITEM_ALIGN = 32          # the kernels' record chunk


def item_length(n_records: int, resident: int, S: int) -> int:
    """The kernels' item length L (``csrc/idg_plan.cuh``): the larger of
    ``ITEM_FLOOR·S`` (an item's extra sandwich, 16·S³, stays within 1/16 of
    its records' 8·S² each) and half a resident block's even share of the
    ``n_records`` records (the records' row length), rounded up to whole
    chunks."""
    share = -(-n_records // (2 * resident))
    return max(ITEM_FLOOR * S, -(-share // ITEM_ALIGN) * ITEM_ALIGN)


def extra_items(n_records: int, S: int) -> int:
    """A bound on the items beyond one a run, whatever the device: a split
    run of m > L records adds ``⌈m/L⌉ − 1 < m/L``, and ``L ≥
    ITEM_FLOOR·S``.  The kernels' scratch holds this many."""
    return n_records // (ITEM_FLOOR * S) + 1


def run_items(starts, ends, n_records: int, resident: int, S: int):
    """Plain version of the kernels' work items: ``(run, start, end)``
    int32 ``[k]``, item j of run r holding the records ``[starts[r] + j·L,
    min(starts[r] + (j + 1)·L, ends[r]))`` with ``L =``
    :func:`item_length` ``(n_records, resident, S)``, in table order.  A
    run of at most L records is one item, an empty entry none; so every
    record of a run lies in exactly one item, and no item is longer than
    L.  Gridding is linear, so gridding the items (each with its run's
    origin, pair and screens) gives the runs' grid; degridding reads each
    record against its run's image, so the items predict the runs'
    visibilities."""
    L = item_length(n_records, resident, S)
    st = starts.long()
    m = torch.clamp(ends.long() - st, min=0)
    k = (m + L - 1) // L
    run = torch.repeat_interleave(torch.arange(k.numel(), device=st.device),
                                  k)
    piece = torch.arange(run.numel(), device=st.device) - (
        torch.cumsum(k, 0) - k)[run]
    first = st[run] + piece * L
    last = torch.minimum(first + L, ends.long()[run])
    return run.int(), first.int(), last.int()


def split_counts(run) -> tuple[int, int]:
    """``(runs split, items made from them)`` of :func:`run_items`' runs:
    what the kernels count as ``split/<kernel>/runs`` and ``.../items``."""
    per_run = torch.bincount(run.long())
    split = per_run[per_run > 1]
    return int(split.numel()), int(split.sum())


@contextlib.contextmanager
def _full_f32_matmul():
    """Pin float32 products to full precision (no TF32) for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _run_members(starts, ends, active):
    """For the runs ``active``: each member record's run (index into
    ``active``) and its position in the sorted record stream."""
    dev = starts.device
    st = starts[active].long()
    counts = ends[active].long() - st
    run_of = torch.repeat_interleave(
        torch.arange(active.numel(), device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    rec = (torch.arange(run_of.numel(), device=dev) - first[run_of]
           + st[run_of])
    return run_of, rec


def _phase_factors(S: int, theta: float, theta_x: float, dev):
    """``(dy, dx, w) ↦ (e_y [b, S], e_x [b, S])`` with the kernels' float32
    phases ``2π/S·c_q·d − π·(c_q·θ/S)²·w``."""
    f32 = torch.float32
    cq = torch.arange(S, dtype=f32, device=dev) - S // 2
    two_pi_s = torch.tensor(2.0 * math.pi / S, dtype=f32, device=dev)
    pi_ = torch.tensor(math.pi, dtype=f32, device=dev)
    ky = pi_ * (cq * (theta / S)) ** 2
    kx = pi_ * (cq * (theta_x / S)) ** 2
    cqs = two_pi_s * cq

    def phases(dy, dx, w):
        ph_y = cqs[None, :] * dy[:, None] - ky[None, :] * w[:, None]
        ph_x = cqs[None, :] * dx[:, None] - kx[None, :] * w[:, None]
        return (torch.polar(torch.ones_like(ph_y), ph_y),
                torch.polar(torch.ones_like(ph_x), ph_x))

    return phases


def _pair_screens(screens, ia1, ia2):
    """``(A[ia1], A[ia2])`` with the ids clamped to ``[0, nant − 1]``, as
    the kernels clamp them."""
    nant = screens.shape[0]
    scr = screens.to(torch.complex64)
    return (scr[torch.clamp(ia1.long(), 0, nant - 1)],
            scr[torch.clamp(ia2.long(), 0, nant - 1)])


def _run_block(S: int, dev) -> int:
    """Runs the plain versions take at once: their ``[R, S, S]``
    temporaries stay within 512 MiB on a card and 64 MiB on the CPU, so a
    run table of a million per-pair runs fits in device memory."""
    budget = 2**29 if dev.type == "cuda" else 2**26
    return max(1, budget // (8 * S * S))


def grid_from_records_plain(recs, starts, ends, y0, x0, ia1, ia2, screens,
                            *, grid_shape, theta: float, subgrid: int = 64,
                            taper_beta: float = 12.0):
    """Plain PyTorch version of the CUDA gridder: the padded complex64
    grid ``[N + 2S, Nx + 2S]`` from run records, on the records' device.

    Occupied runs are processed in blocks of at most :func:`_run_block`
    runs, and their records in chunks: the records' rank-1 phase terms are
    summed into per-run accumulators with ``index_add_``; the pair screens
    and the sandwich then run as one batched product over the block's
    runs, and the patches are added to the grid by flat index.  A run
    whose patch would leave the padded grid adds nothing, as in the
    kernel.
    """
    N, Nx = grid_shape
    S = subgrid
    HP, WP = N + 2 * S, Nx + 2 * S
    dev = recs.device
    out = torch.zeros((HP, WP), dtype=torch.complex64, device=dev)
    inside = (y0 >= 0) & (x0 >= 0) & (y0 <= HP - S) & (x0 <= WP - S)
    active_all = torch.nonzero((ends > starts) & inside).squeeze(1)
    phases = _phase_factors(S, theta, theta * Nx / N, dev)
    chunk = 8192 if dev.type == "cuda" else 1024     # bounds the temporaries
    F, FT = _dft_factors(S, taper_beta, dev)
    ar = torch.arange(S, device=dev)
    block = _run_block(S, dev)
    for r0 in range(0, active_all.numel(), block):
        active = active_all[r0:r0 + block]
        run_of, rec = _run_members(starts, ends, active)
        acc = torch.zeros((active.numel(), S, S, 2), dtype=torch.float32,
                          device=dev)
        with _full_f32_matmul():
            for c0 in range(0, rec.numel(), chunk):
                idx = rec[c0:c0 + chunk]
                dy, dx, w, vr, vi = recs[:, idx]
                ey, ex = phases(dy, dx, w)
                u = torch.complex(vr, vi)[:, None] * ey
                outer = u[:, :, None] * ex[:, None, :]
                acc.index_add_(0, run_of[c0:c0 + chunk],
                               torch.view_as_real(outer))

            a1, a2 = _pair_screens(screens, ia1[active], ia2[active])
            t = torch.view_as_complex(acc) * torch.conj(a1 * a2)
            patch = F @ t @ FT                              # [R, S, S]

        rows = y0[active].long()[:, None] + ar
        cols = x0[active].long()[:, None] + ar
        flat = (rows[:, :, None] * WP + cols[:, None, :]).reshape(-1)
        torch.view_as_real(out).view(-1, 2).index_add_(
            0, flat, torch.view_as_real(patch).reshape(-1, 2))
    return out


def pad_grid(grid, subgrid: int):
    """The plain degridder's padded complex64 grid ``[N + 2S, Nx + 2S]``
    with ``grid`` at offset S."""
    N, Nx = grid.shape
    S = subgrid
    gp = torch.zeros((N + 2 * S, Nx + 2 * S), dtype=torch.complex64,
                     device=grid.device)
    gp[S:S + N, S:S + Nx] = grid
    return gp


def degrid_from_records_plain(recs, starts_ext, y0, x0, ia1, ia2, order_s,
                              grid, screens, *, theta: float,
                              subgrid: int = 64, taper_beta: float = 12.0):
    """Plain PyTorch version of the CUDA degridder, with the arguments of
    :func:`idg_aw_degrid_from_records_stream`: visibilities ``[n]``
    complex64 in the records' original order from the ``[N, Nx]`` model
    grid, on the records' device.

    The run images ``(Fᴴ·W·conj(F)) ∘ (A[ia1]·A[ia2])`` are one batched
    product over a block of at most :func:`_run_block` occupied runs; the
    block's records are then contracted in chunks against their run's
    image and scattered to ``order_s``.  Sentinel runs (pair id 2¹⁵) and
    records past the run table predict exactly 0.
    """
    S = subgrid
    N, Nx = grid.shape
    n = order_s.shape[0]
    starts = starts_ext[:-1]
    ends = torch.clamp(starts_ext[1:], max=n)
    dev = recs.device
    out = torch.zeros((n,), dtype=torch.complex64, device=dev)
    active_all = torch.nonzero((ends > starts)
                               & (ia1 < PAIR_SHIFT)).squeeze(1)
    if active_all.numel() == 0:
        return out
    ar = torch.arange(S, device=dev)
    gp = pad_grid(grid, S)
    phases = _phase_factors(S, theta, theta * Nx / N, dev)
    chunk = (2**25 if dev.type == "cuda" else 2**22) // (S * S)
    F, _ = _dft_factors(S, taper_beta, dev)
    block = _run_block(S, dev)
    for r0 in range(0, active_all.numel(), block):
        active = active_all[r0:r0 + block]
        run_of, rec = _run_members(starts, ends, active)
        rows = y0[active].long()[:, None] + ar
        cols = x0[active].long()[:, None] + ar
        win = gp[rows[:, :, None], cols[:, None, :]]
        with _full_f32_matmul():
            a1, a2 = _pair_screens(screens, ia1[active], ia2[active])
            img = (F.conj().T @ win @ F.conj()) * (a1 * a2)  # [R, S, S]
            for c0 in range(0, rec.numel(), chunk):
                idx = rec[c0:c0 + chunk]
                ey, ex = phases(*recs[:3, idx])
                t = torch.einsum("bqr,br->bq", img[run_of[c0:c0 + chunk]],
                                 ex.conj())
                out[order_s[idx].long()] = torch.sum(ey.conj() * t, dim=1)
    return out


def _check_cuda_inputs(recs, runs, screens, S: int, rows: int = 5):
    dev = recs.device
    if recs.dtype != torch.float32 or recs.dim() != 2 \
            or recs.shape[0] != rows:
        raise ValueError(f"recs must be [{rows}, n] float32, got "
                         f"{tuple(recs.shape)} {recs.dtype}")
    n_runs = runs[0].shape[0]
    for t in runs:
        if t.dtype != torch.int32 or t.shape != (n_runs,):
            raise ValueError("run tables must be int32 of one length")
    if screens.dtype != torch.complex64 or screens.dim() != 3 \
            or tuple(screens.shape[1:]) != (S, S):
        raise ValueError(f"screens must be [nant, {S}, {S}] complex64")
    for t in (recs, screens, *runs):
        if t.device != dev:
            raise ValueError("all kernel inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def _phase_scalars(S: int, theta: float, N: int, Nx: int):
    """The kernels' float arguments ``(2π/S, θ/S, θ_x/S)``."""
    return (float(np.float32(2.0 * np.pi / S)), float(theta / S),
            float(theta * Nx / N / S))


def resident_blocks(kernel: str, S: int) -> int:
    """The blocks of ``kernel``'s (:data:`GRID_KERNEL` or
    :data:`DEGRID_KERNEL`) subgrid-S instance that the current CUDA device
    holds at once: the ``resident`` of :func:`item_length` in its
    launches."""
    lib = {GRID_KERNEL: "idg_grid", DEGRID_KERNEL: "idg_degrid"}[kernel]
    fn, err = bind(lib, f"{lib}_resident", [ctypes.c_int])
    n = fn(S)
    if n <= 0:
        raise RuntimeError(f"{lib}_resident: {err(-n).decode()} ({-n})")
    return n


def _count_split(counts, name: str) -> None:
    """Count a launch's split runs and their items (``counts`` ``[2]`` on
    the card) as ``split/<name>/runs`` and ``split/<name>/items``, and as
    the root span's ``idg_split_runs`` and ``idg_items``, once the card
    has them."""
    count_on_card(counts, (f"split/{name}/runs", f"split/{name}/items"),
                  ("idg_split_runs", "idg_items"))


def _grid_from_records_cuda(recs, starts, ends, y0, x0, ia1, ia2, screens,
                            *, grid_shape, theta: float, subgrid: int,
                            taper_beta: float):
    """Launch ``csrc/idg_grid.cu`` on the current stream; returns the padded
    grid and a 0-dim int32 tensor, nonzero if an item was skipped because
    its patch would leave the grid (read it back to check; the prep never
    makes such a run).  The launch first sorts the run table's work items
    (:func:`run_items`) into the order its blocks take them by, in a
    scratch buffer of 8 counters, the order, the split runs' pieces and
    the split runs.
    Raises on bad inputs and on a refused launch."""
    S = subgrid
    N, Nx = grid_shape
    HP, WP = N + 2 * S, Nx + 2 * S
    dev = recs.device
    # zeroed first: the card clears the grid while the host checks
    out = torch.zeros((HP, WP), dtype=torch.complex64, device=dev)
    check_subgrid(S)
    runs = (starts, ends, y0, x0, ia1, ia2)
    _check_cuda_inputs(recs, runs, screens, S)
    n_runs = starts.shape[0]
    if n_runs == 0:
        launched(GRID_KERNEL)
        return out, torch.zeros((), dtype=torch.int32, device=dev)
    planes = _dft_planes(S, taper_beta, dev)
    scr = _padded_screens(screens, S)
    extra = extra_items(recs.shape[1], S)
    scratch = torch.empty((8 + n_runs + 4 * extra,), dtype=torch.int32,
                          device=dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn, err = bind("idg_grid", "idg_grid_stream",
                    [vp, ctypes.c_longlong, vp, ci, vp, vp, vp, vp, vp, vp,
                     ci, vp, ci, vp, vp, ci, ci, ci, cf, cf, cf, vp])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(recs.data_ptr(), recs.shape[1], scratch.data_ptr(), extra,
                starts.data_ptr(), ends.data_ptr(), y0.data_ptr(),
                x0.data_ptr(), ia1.data_ptr(), ia2.data_ptr(), n_runs,
                scr.data_ptr(), scr.shape[0], planes.data_ptr(),
                out.data_ptr(), HP, WP, S,
                *_phase_scalars(S, theta, N, Nx), stream)
        if rc != 0:
            raise RuntimeError(f"{GRID_KERNEL} launch failed: "
                               f"{err(rc).decode()} ({rc})")
        _count_split(scratch[3:5], "idg_grid")
    launched(GRID_KERNEL)
    return out, scratch[1]


def _degrid_from_records_cuda(recs, starts, ends, y0, x0, ia1, ia2, order_s,
                              screens, *, grid, theta: float, subgrid: int,
                              taper_beta: float):
    """Launch ``csrc/idg_degrid.cu`` on the current stream; returns the
    visibilities in original order.  The kernel reads ``grid``, the
    ``[N, Nx]`` model grid, at the runs' padded origins (zero outside it).
    Raises on bad inputs and on a refused launch."""
    S = subgrid
    check_subgrid(S)
    runs = (starts, ends, y0, x0, ia1, ia2)
    _check_cuda_inputs(recs, runs, screens, S, rows=3)
    n = recs.shape[1]
    if order_s.dtype != torch.int32 or order_s.shape != (n,) \
            or order_s.device != recs.device or not order_s.is_contiguous():
        raise ValueError(f"order_s must be [{n}] contiguous int32 on the "
                         "records' device")
    N, Nx = grid.shape
    if grid.dtype != torch.complex64 or grid.device != recs.device \
            or not grid.is_contiguous():
        raise ValueError("the model grid must be contiguous complex64 on "
                         "the records' device")
    dev = recs.device
    out = torch.zeros((n,), dtype=torch.complex64, device=dev)
    n_runs = starts.shape[0]
    if n_runs == 0:
        launched(DEGRID_KERNEL)
        return out
    planes = _dft_planes_adjoint(S, taper_beta, dev)
    scr = _padded_screens(screens, S)
    extra = extra_items(n, S)
    scratch = torch.empty((4 + 2 * extra,), dtype=torch.int32, device=dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn, err = bind("idg_degrid", "idg_degrid_stream",
                    [vp, ctypes.c_longlong, vp, ci, vp, vp, vp, vp, vp, vp,
                     ci, vp, vp, ci, vp, vp, ci, ci, ci, cf, cf, cf, vp, vp])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(recs.data_ptr(), n, scratch.data_ptr(), extra,
                starts.data_ptr(), ends.data_ptr(), y0.data_ptr(),
                x0.data_ptr(), ia1.data_ptr(), ia2.data_ptr(), n_runs,
                order_s.data_ptr(), scr.data_ptr(), scr.shape[0],
                planes.data_ptr(), grid.data_ptr(), N, Nx, S,
                *_phase_scalars(S, theta, N, Nx), out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{DEGRID_KERNEL} launch failed: "
                               f"{err(rc).decode()} ({rc})")
        _count_split(scratch[1:3], "idg_degrid")
    launched(DEGRID_KERNEL)
    return out


def idg_aw_grid_from_records_stream(recs, starts, ends, y0, x0, ia1, ia2,
                                    grid_shape, screens, *, theta: float,
                                    subgrid: int = 64,
                                    taper_beta: float = 12.0):
    """Streamed IDG(-AW) gridding of prepared run records; returns the
    ``[N, Nx]`` complex64 grid.

    CUDA tensors launch the CUDA kernel; CPU tensors take the plain
    version.  ``screens`` is ``[nant, S, S]`` complex64, unconjugated.
    """
    N, Nx = grid_shape
    S = subgrid
    kw = dict(grid_shape=grid_shape, theta=theta, subgrid=S,
              taper_beta=taper_beta)
    with span("sdp.kernel.idg_grid"):
        if recs.is_cuda:
            g, _ = _grid_from_records_cuda(recs, starts, ends, y0, x0, ia1,
                                           ia2, screens, **kw)
        elif recs.device.type == "cpu":
            g = grid_from_records_plain(recs, starts, ends, y0, x0, ia1,
                                        ia2, screens, **kw)
        else:
            raise ValueError(f"no gridder for device {recs.device}")
    return g[S:S + N, S:S + Nx]


def idg_aw_gridder_stream(grid_shape, p, a1, a2, w, vis, screens, *,
                          theta: float, subgrid: int = 64, support: int = 15,
                          taper_beta: float = 12.0, max_runs: int = 4096,
                          fit_margin: int = 0, ordered: bool = False):
    """Streamed IDG(-AW) gridding end to end (prep + gridder) on complex
    visibilities; returns ``(guv [N, Nx] complex64, n_dropped)``."""
    with span("sdp.device_prep"):
        (recs, starts, ends, y0, x0, ia1, ia2, n_dropped,
         _) = idg_aw_run_records(
            grid_shape, p, a1, a2, w, vis.real, vis.imag, subgrid=subgrid,
            support=support, max_runs=max_runs, fit_margin=fit_margin,
            ordered=ordered, nant=screens.shape[0])
    guv = idg_aw_grid_from_records_stream(
        recs, starts, ends, y0, x0, ia1, ia2, grid_shape,
        screens.to(torch.complex64).contiguous(), theta=theta,
        subgrid=subgrid, taper_beta=taper_beta)
    return guv, n_dropped


def idg_aw_degrid_from_records_stream(recs, starts_ext, y0, x0, ia1, ia2,
                                      order_s, grid, screens, *,
                                      theta: float, subgrid: int = 64,
                                      taper_beta: float = 12.0):
    """Streamed IDG(-AW) degridding of prepared records (the first seven
    entries of ``idg_aw_degrid_records``) from the ``[N, Nx]`` model grid;
    returns ``[n]`` complex64 visibilities in the records' original order.

    CUDA tensors launch the CUDA kernel; CPU tensors take the plain
    version.  ``screens`` is ``[nant, S, S]`` complex64, unconjugated.
    """
    kw = dict(theta=theta, subgrid=subgrid, taper_beta=taper_beta)
    with span("sdp.kernel.idg_degrid"):
        if recs.is_cuda:
            n = recs.shape[1]
            return _degrid_from_records_cuda(
                recs, starts_ext[:-1], torch.clamp(starts_ext[1:], max=n),
                y0, x0, ia1, ia2, order_s, screens,
                grid=grid.to(torch.complex64).contiguous(), **kw)
        if recs.device.type == "cpu":
            return degrid_from_records_plain(recs, starts_ext, y0, x0, ia1,
                                             ia2, order_s, grid, screens,
                                             **kw)
        raise ValueError(f"no degridder for device {recs.device}")


def idg_aw_degridder_stream(grid_shape, p, a1, a2, w, grid, screens, *,
                            theta: float, subgrid: int = 64,
                            support: int = 15, taper_beta: float = 12.0,
                            max_runs: int = 4096, fit_margin: int = 0):
    """Streamed IDG(-AW) degridding end to end (prep + degridder) of the
    ``[N, Nx]`` grid; returns ``(vis [n] complex64, n_dropped)``.  Records
    the prep could not place predict 0 and are counted in ``n_dropped``."""
    if tuple(grid.shape) != tuple(grid_shape):
        raise ValueError(f"grid {tuple(grid.shape)} does not match "
                         f"grid_shape {tuple(grid_shape)}")
    with span("sdp.device_prep"):
        recs = idg_aw_degrid_records(grid_shape, p, a1, a2, w,
                                     subgrid=subgrid, support=support,
                                     max_runs=max_runs,
                                     fit_margin=fit_margin)
    vis = idg_aw_degrid_from_records_stream(
        *recs[:7], grid, screens.to(torch.complex64).contiguous(),
        theta=theta, subgrid=subgrid, taper_beta=taper_beta)
    return vis, recs[8]
