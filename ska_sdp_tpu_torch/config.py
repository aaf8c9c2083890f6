"""Configuration surface (port of ``ska_sdp_tpu/config.py``, the parts the
ported imaging paths read)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from .types import Precision, precision


@dataclasses.dataclass(frozen=True)
class KernelOptions:
    """Options of w-kernel synthesis (the reference's field meanings):
    oversampling, far-field and kernel sizes.  The reference's pattern
    shift and 2×2 transform, which no ported caller sets, and its
    ``wstep``, which belongs to the w-cache mode, are not ported."""

    qpx: int = 8                 # oversampling factor of the kernel
    npix_ff: int = 256           # far-field (image-plane) pixel count
    npix_kern: int = 15          # extracted convolution-kernel support


@dataclasses.dataclass(frozen=True)
class GridParams:
    """Field of view and grid resolution; ``n = round(theta * lam)``
    (θ=0.008, lam=300000 gives the 2400² SKA1-Low grid)."""

    theta: float = 0.008
    lam: int = 300000

    @property
    def n(self) -> int:
        # Python round() is round-half-to-even, like the reference
        return int(round(self.theta * self.lam))


@dataclasses.dataclass(frozen=True)
class ImagingConfig:
    """Pipeline configuration (CLI surface)."""

    grid: GridParams = GridParams()
    precision_name: str = "single"
    n_vis: Optional[int] = None  # visibility-count cap (CLI -n); None = all

    @property
    def precision(self) -> Precision:
        return precision(self.precision_name)  # type: ignore[arg-type]
