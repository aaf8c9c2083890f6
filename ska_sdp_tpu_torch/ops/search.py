"""Closest-bin search over sorted bin centres (port of
``ska_sdp_tpu/ops/search.py``).

``torch.searchsorted`` plus a neighbour comparison, batched over the
visibility vector; ties go to the higher index, as the reference's strict
``<`` does.
"""

from __future__ import annotations

import torch


def find_closest(sorted_vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """int32 index of the entry of ``sorted_vals`` closest to each element
    of ``x``; values outside the range go to the nearest end, exact ties
    to the higher index."""
    n = sorted_vals.shape[0]
    dt = torch.promote_types(sorted_vals.dtype, x.dtype)
    sv = sorted_vals.to(dt).contiguous()
    x = x.to(dt).contiguous()
    hi = torch.clamp(torch.searchsorted(sv, x, right=True), 1, n - 1)
    lo = hi - 1
    d_lo = torch.abs(x - sv[lo])
    d_hi = torch.abs(x - sv[hi])
    return torch.where(d_lo < d_hi, lo, hi).to(torch.int32)
