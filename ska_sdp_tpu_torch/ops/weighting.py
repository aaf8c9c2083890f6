"""Uniform weighting by uv-cell occupancy (port of
``ska_sdp_tpu/ops/weighting.py``): a float count histogram by scatter-add
at qpx=1 resolution, then a gather at each visibility's own cell.

The two halves are separate functions so that a sharded step can sum the
histograms of every shard between them (``parallel/sharded.py``).  Cell
ids follow the reference's indexing semantics exactly: a negative flat id
counts from the end (once), the scatter drops ids still out of range and
the gather clamps them.
"""

from __future__ import annotations

import torch

from .coords import frac_coords


def weight_cells(theta: float, lam: int, uvw: torch.Tensor) -> torch.Tensor:
    """Flat int64 qpx=1 cell id ``y·n + x`` of each visibility (``uvw`` in
    wavelengths, not scaled by ``lam``), negative ids wrapped once."""
    n = int(round(theta * lam))
    x, _, y, _ = frac_coords((n, n), 1, uvw / lam)
    flat = y.to(torch.int64) * n + x.to(torch.int64)
    return torch.where(flat < 0, flat + n * n, flat)


def cell_counts(flat: torch.Tensor, size: int,
                weights: torch.Tensor) -> torch.Tensor:
    """``[size]`` histogram of ``weights`` (real) at cells ``flat``; ids
    outside ``[0, size)`` add nothing."""
    inb = (flat >= 0) & (flat < size)
    counts = torch.zeros((size,), dtype=weights.dtype, device=flat.device)
    # an id out of range adds 0 at a clamped cell: no host sync
    counts.index_add_(0, flat.clamp(0, size - 1),
                      torch.where(inb, weights, torch.zeros_like(weights)))
    return counts


def counts_at(counts: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """The histogram at cells ``flat``, ids clamped into range."""
    return counts[flat.clamp(0, counts.shape[0] - 1)]


def doweight(theta: float, lam: int, uvw: torch.Tensor,
             vis: torch.Tensor) -> torch.Tensor:
    """Divide each visibility by the number of visibilities in its cell.

    ``uvw`` is in wavelengths (not scaled by ``lam``)."""
    n = int(round(theta * lam))
    flat = weight_cells(theta, lam, uvw)
    counts = cell_counts(flat, n * n, torch.ones(flat.shape, dtype=uvw.dtype,
                                                 device=uvw.device))
    return vis / counts_at(counts, flat).to(vis.dtype)
