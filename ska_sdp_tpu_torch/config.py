"""Configuration surface (port of ``ska_sdp_tpu/config.py``, the parts the
ported imaging paths read)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from .types import Precision, precision


@dataclasses.dataclass(frozen=True)
class KernelOptions:
    """Options of w-kernel synthesis (the reference's field meanings):
    oversampling, far-field and kernel sizes, the w-cache mode's bin
    width, and the pattern shift and 2×2 transform that
    ``ops.wkernel.kernel_coordinates`` applies to the image-plane
    coordinates (the defaults leave them as they are)."""

    qpx: int = 8                 # oversampling factor of the kernel
    npix_ff: int = 256           # far-field (image-plane) pixel count
    npix_kern: int = 15          # extracted convolution-kernel support
    wstep: int = 2000            # w-bin width of the w-kernel cache (λ)
    pat_hor_shift: int = 0
    pat_ver_shift: int = 0
    pat_trans_mat: Optional[tuple] = None  # 2x2 row-major matrix or None


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
