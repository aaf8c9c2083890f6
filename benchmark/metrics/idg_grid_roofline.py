"""idg_grid_roofline (%, higher): the IDG gridding operator's least time
(``roofline.idg_work`` at the request's records and its distinct
(station pair, uv tile) subgrids, screens only with A-terms) over the
device time of the port's hand kernels (``csrc/idg_grid.cu``) in the
traced image requests.  At these shapes bytes bound plain IDG (the 121 MB
grid) and operations IDG-AW (its 131 k run sandwiches).  Cells
``idg.cycle`` and ``idg-aw.cycle``."""

from benchmark.metrics._util import kernel_share
from benchmark.reference import idg
from benchmark.roofline import idg_work


def _work(m, r):
    aw = "akerns" in r.step["inputs"]
    n_rec, n_runs = m.cached(r, "idg_runs", lambda req: idg.runs(
        req, m.cfg, m.device, aw, imaging=True))
    nant = len(r.req["akerns"]) if aw else 0
    return idg_work(n_rec, n_runs, m.cfg["subgrid"], m.grid_n, nant)


def read(m):
    return kernel_share(m, "idg_grid", _work)
