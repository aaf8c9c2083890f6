"""Plain tensor operations (PyTorch): coordinates, weighting, Hermitian
completion, centred FFTs and the IDG geometry."""

from .coords import frac_coord, frac_coords, mirror_uvw, uvw_lambda
from .fourier import extract_mid, fft_centered, ifft_centered, pad_mid
from .hermitian import make_grid_hermitian
from .weighting import doweight

__all__ = [
    "doweight",
    "extract_mid",
    "fft_centered",
    "frac_coord",
    "frac_coords",
    "ifft_centered",
    "make_grid_hermitian",
    "mirror_uvw",
    "pad_mid",
    "uvw_lambda",
]
