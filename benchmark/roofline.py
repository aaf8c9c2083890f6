"""Peaks of the card and the least work of each hand-written kernel, counted
from the algorithm at the cell's own inputs, not from how a kernel
computes it.

A corrected copy of ``chip_smoke.py``'s ``bound``, ``sandwich_flop`` and
``idg_stream_bounds``: the operations are held against the dense
fp16/bf16 tensor-core peak (the port's split-fp16 kernels reach float32
accuracy on the tensor cores, so a float32 peak could be beaten), and
the kernel-specific split3 term (three passes of 8·S² a record) is left
out, so that the bound reads the same whatever implements the operator.
"""

from __future__ import annotations

import math

TC_FLOPS = 989e12     # H100 SXM dense fp16/bf16 tensor-core peak, 700 W
HBM_BPS = 3.35e12     # H100 SXM device-memory rate
C64 = 8               # bytes of a complex64


def least_time(flops: float, nbytes: float):
    """``(seconds, "operations" | "bytes")``: the larger of the operations
    over the operations peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / TC_FLOPS, nbytes / HBM_BPS
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sandwich_flops(S: int) -> float:
    """Operations of one S×S subgrid sandwich ``F·a·Fᵀ`` with the taper
    folded in: the lesser of two dense complex S³ products (16·S³) and a
    taper multiply plus a 2-D radix-2 FFT (10·S²·log2 S + 6·S²)."""
    return min(16 * S ** 3, 10 * S * S * math.log2(S) + 6 * S * S)


def idg_work(n_rec: int, n_runs: int, S: int, N: int, nant: int = 0):
    """``(flops, bytes)`` of IDG gridding or degridding of ``n_rec``
    records in ``n_runs`` subgrids (distinct station pair and uv tile):
    8·S² a record (its rank-1 phase term accumulated, or contracted), and
    a run's sandwich plus, with ``nant`` A-screens, 12·S² for the pair's
    screen product.  Bytes: u, v, w and the visibility of each record
    (20), the N² complex64 grid once, the screens and a run's pair ids."""
    flops = 8 * S * S * n_rec + n_runs * (sandwich_flops(S)
                                          + (12 * S * S if nant else 0))
    nbytes = 20 * n_rec + C64 * N * N
    if nant:
        nbytes += C64 * nant * S * S + 8 * n_runs
    return flops, nbytes


def wproj_work(n_taps: int, n_rec: int, bank_bytes: int, N: int):
    """``(flops, bytes)`` of the bank scatter or gather: 8 operations a
    patch cell inside the grid (a complex multiply and add); bytes: u, v,
    w, plane index and visibility of each record (24), the bank and the
    N² complex64 grid once."""
    return 8 * n_taps, 24 * n_rec + bank_bytes + C64 * N * N
