"""wproj_degrid_roofline (%, higher): the bank gather's least time
(``roofline.wproj_work``, as for the scatter) over the device time of the
port's hand kernels (``csrc/wproj_degrid.cu`` with its CUB sort) in the
traced prediction requests.  Bytes bound it at these shapes (the 121 MB
grid).  Cell ``wproj.dumpcycle``."""

from benchmark.metrics._util import kernel_share
from benchmark.reference import wproj
from benchmark.roofline import wproj_work


def _work(m, r):
    n_taps = m.cached(r, "wproj_taps", lambda req: wproj.taps(
        req, m.cfg, m.device, imaging=False))
    bank = r.req["wkerns"]
    return wproj_work(n_taps, len(r.req["uvw"]),
                      bank.numel() * bank.element_size(), m.grid_n)


def read(m):
    return kernel_share(m, "wproj_degrid", _work)
