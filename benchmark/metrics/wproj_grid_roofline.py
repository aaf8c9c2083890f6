"""wproj_grid_roofline (%, higher): the bank scatter's least time
(``roofline.wproj_work``: 8 operations a patch cell inside the grid; the
records, the bank and the grid once) over the device time of the port's
hand kernels (``csrc/wproj_grid.cu`` with its CUB sort) in the traced
image requests.  Bytes bound it at these shapes (the 121 MB grid).  Cells
``wproj.dumpcycle`` and ``wproj.fast``."""

from benchmark.metrics._util import kernel_share
from benchmark.reference import wproj
from benchmark.roofline import wproj_work


def _work(m, r):
    n_taps = m.cached(r, "wproj_taps", lambda req: wproj.taps(
        req, m.cfg, m.device, imaging=True))
    bank = r.req["wkerns"]
    return wproj_work(n_taps, len(r.req["uvw"]),
                      bank.numel() * bank.element_size(), m.grid_n)


def read(m):
    return kernel_share(m, "wproj_grid", _work)
