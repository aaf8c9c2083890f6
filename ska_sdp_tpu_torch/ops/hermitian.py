"""Hermitian completion of the uv-grid (port of
``ska_sdp_tpu/ops/hermitian.py``)."""

from __future__ import annotations

import torch


def make_grid_hermitian(guv: torch.Tensor) -> torch.Tensor:
    """``g + conj(mirror(g))``.  Odd sizes mirror by full reversal; even
    sizes mirror through the off-centre zero point, ``g[n−y, n−x]``, with
    row 0 and column 0 of the mirror zeroed."""
    n = guv.shape[-1]
    mirr = torch.flip(guv, dims=(-2, -1))
    if n % 2 == 0:
        mirr = torch.roll(mirr, shifts=(1, 1), dims=(-2, -1))
        mirr[..., 0, :] = 0
        mirr[..., :, 0] = 0
    return guv + torch.conj(mirr)
