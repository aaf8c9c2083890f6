"""Imaging functions: uvw → uv-grid (port of the AW-projection part of
``ska_sdp_tpu/models/imaging.py``).

``aw_imaging`` has the reference's ``ImagingFunction`` signature (θ, lam,
uvw, src, vis) → uv-grid with the kernels passed in front.
"""

from __future__ import annotations

import torch

from ..kernels import aw_gridder
from ..ops.search import find_closest


def _empty_grid(theta: float, lam: int, dtype, device=None) -> torch.Tensor:
    n = int(round(theta * lam))
    return torch.zeros((n, n), dtype=dtype, device=device)


def aw_imaging(theta: float, lam: int, wkernels: torch.Tensor,
               wbin_centers: torch.Tensor, akernels: torch.Tensor,
               uvw: torch.Tensor, src, vis: torch.Tensor,
               chunk: int = 8192) -> torch.Tensor:
    """AW-projection uv-grid ``[n, n]``, ``n = round(θ·lam)``.

    ``wkernels`` ``[nw, qpx, qpx, s, s]`` is the unconjugated bank,
    ``wbin_centers`` ``[nw]`` its plane centres in wavelengths, ``akernels``
    ``[nant, s, s]`` the A-kernels; ``src`` starts with ``(a1, a2)``, each
    visibility's antennas (the reference passes ``(a1, a2, time, freq)``;
    only the antennas are read).  Each visibility takes the plane closest to
    its w."""
    a1, a2 = src[0].to(torch.int32), src[1].to(torch.int32)
    guv = _empty_grid(theta, lam, vis.dtype, vis.device)
    wbin = find_closest(wbin_centers, uvw[:, 2])
    return aw_gridder(wkernels, akernels, guv, uvw / lam, wbin, a1, a2, vis,
                      chunk=chunk)

