"""uv→grid coordinate mapping and uvw preprocessing (port of
``ska_sdp_tpu/ops/coords.py``).

``p`` is the uvw baseline scaled into the ±0.5 box; grid cells are
``(y, x) = (cell(v), cell(u))``; ``round`` is round-half-to-even.
"""

from __future__ import annotations

import torch

from ..types import SPEED_OF_LIGHT


def frac_coord(n: int, qpx: int, p: torch.Tensor):
    """(cell, oversampling fraction) of scaled coordinates ``p``:
    ``x = n/2 + p·n``, ``cell = floor(x + 0.5/qpx)``,
    ``frac = round((x − cell)·qpx)``.  Returns two int32 tensors."""
    x = n // 2 + p * n
    cell = torch.floor(x + 0.5 / qpx)
    frac = torch.round((x - cell) * qpx)
    return cell.to(torch.int32), frac.to(torch.int32)


def frac_coords(shape_hw, qpx: int, p_uvw: torch.Tensor):
    """:func:`frac_coord` on u (width) and v (height): ``(x, xf, y, yf)``."""
    h, w = shape_hw
    x, xf = frac_coord(w, qpx, p_uvw[..., 0])
    y, yf = frac_coord(h, qpx, p_uvw[..., 1])
    return x, xf, y, yf


def uvw_lambda(freq, uvw: torch.Tensor) -> torch.Tensor:
    """Scale uvw from metres to wavelengths: ``uvw · f / c``, with the
    scale formed in ``uvw``'s dtype as the reference does."""
    f = torch.as_tensor(freq, dtype=uvw.dtype, device=uvw.device)
    return uvw * (f / SPEED_OF_LIGHT)


def mirror_uvw(uvw: torch.Tensor, vis: torch.Tensor):
    """Mirror baselines into v ≥ 0: where v < 0 negate the uvw triple and
    conjugate the visibility (Hermitian symmetry)."""
    neg = uvw[:, 1] < 0
    uvw_m = torch.where(neg[:, None], -uvw, uvw)
    vis_m = torch.where(neg, torch.conj(vis), vis)
    return uvw_m, vis_m
