"""Type vocabulary and precision policy (port of ``ska_sdp_tpu/types.py``).

``single`` (float32 / complex64) is the production policy on the GPU;
``double`` (float64 / complex128) is the parity policy.  Array layouts are
the reference's: visibilities ``[n]`` complex, uvw ``[n, 3]`` real, the
uv-grid ``[N, Nx]`` complex indexed ``[y(v), x(u)]``, antenna screens
``[nant, S, S]`` complex.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

SPEED_OF_LIGHT = 299792458.0  # m/s


@dataclasses.dataclass(frozen=True)
class Precision:
    """Scalar-type policy threaded through the pipelines."""

    real: torch.dtype
    complex: torch.dtype

    @property
    def np_real(self) -> np.dtype:
        return np.dtype(np.float64 if self.real == torch.float64
                        else np.float32)

    @property
    def np_complex(self) -> np.dtype:
        return np.dtype(np.complex128 if self.complex == torch.complex128
                        else np.complex64)


SINGLE = Precision(real=torch.float32, complex=torch.complex64)
DOUBLE = Precision(real=torch.float64, complex=torch.complex128)

PrecisionName = Literal["single", "double"]


def precision(name: PrecisionName | Precision = "single") -> Precision:
    if isinstance(name, Precision):
        return name
    if name == "single":
        return SINGLE
    if name == "double":
        return DOUBLE
    raise ValueError(f"unknown precision {name!r}")
