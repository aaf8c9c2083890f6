"""Uniform weighting by uv-cell occupancy (port of
``ska_sdp_tpu/ops/weighting.py``): a float count histogram by scatter-add
at qpx=1 resolution, then a gather at each visibility's own cell."""

from __future__ import annotations

import torch

from .coords import frac_coords


def doweight(theta: float, lam: int, uvw: torch.Tensor,
             vis: torch.Tensor) -> torch.Tensor:
    """Divide each visibility by the number of visibilities in its cell.

    ``uvw`` is in wavelengths (not scaled by ``lam``).  Cell ids outside
    the grid follow the reference's indexing semantics exactly: a negative
    flat id counts from the end, the scatter drops ids still out of range
    and the gather clamps them.
    """
    n = int(round(theta * lam))
    p = uvw / lam
    x, _, y, _ = frac_coords((n, n), 1, p)
    size = n * n
    flat = y.to(torch.int64) * n + x.to(torch.int64)
    flat = torch.where(flat < 0, flat + size, flat)
    inb = (flat >= 0) & (flat < size)
    counts = torch.zeros((size,), dtype=uvw.dtype, device=uvw.device)
    counts.index_add_(0, flat[inb], torch.ones_like(flat[inb],
                                                    dtype=uvw.dtype))
    per_vis = counts[flat.clamp(0, size - 1)]
    return vis / per_vis.to(vis.dtype)
