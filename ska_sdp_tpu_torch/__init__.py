"""ska_sdp_tpu_torch — SKA-SDP visibility gridding and imaging in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``ska_sdp_tpu`` (JAX/XLA/Pallas), which stays beside it as the
reference.  Module names mirror the reference so each counterpart is easy
to find: ``ops/`` (plain tensor math), ``kernels/`` (kernel wrappers and
dispatch), ``models/`` (imaging pipelines), ``io/`` (HDF5 and synthetic
data) and ``csrc/`` (CUDA sources, built with ``nvcc`` at first use).

Importing the package imports torch and numpy only: no jax, no
``ska_sdp_tpu``, and ``h5py`` only inside the HDF5 functions.
"""

from .config import GridParams, ImagingConfig
from .types import DOUBLE, SINGLE, SPEED_OF_LIGHT, Precision, precision

__all__ = [
    "DOUBLE",
    "GridParams",
    "ImagingConfig",
    "Precision",
    "SINGLE",
    "SPEED_OF_LIGHT",
    "precision",
]
