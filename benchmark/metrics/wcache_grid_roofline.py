"""wcache_grid_roofline (%, higher): the w-cache scatter's least time over
a request, two scatters of the bank kernel (the image's and the PSF's:
``roofline.wproj_work`` each, at the patch cells inside the grid of
``reference.psf.taps``, the records, the bytes of one bank of the
configuration's planes and the grid), over the device time of the port's
hand kernels (``csrc/wproj_grid.cu`` with its CUB sort) in the traced
requests.  The bank's synthesis runs in ATen and cuFFT and counts under
``aten_ms`` and ``fft_ms``, not here.  Cell ``wcache.psf``."""

from benchmark.metrics._util import kernel_share
from benchmark.reference import psf
from benchmark.roofline import C64, wproj_work


def _work(m, r):
    cfg = m.cfg
    n_taps = m.cached(r, "wcache_taps", lambda req: psf.taps(
        req, cfg, m.device))
    bank = psf.planes(cfg) * cfg["qpx"] ** 2 * cfg["support"] ** 2 * C64
    flops, nbytes = wproj_work(n_taps, len(r.req["uvw"]), bank, m.grid_n)
    return 2 * flops, 2 * nbytes


def read(m):
    return kernel_share(m, "wproj_grid", _work)
