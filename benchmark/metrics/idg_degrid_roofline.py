"""idg_degrid_roofline (%, higher): the IDG degridding operator's least
time (``roofline.idg_work``, as for the gridder) over the device time of
the port's hand kernels (``csrc/idg_degrid.cu``) in the traced prediction
requests.  At these shapes bytes bound plain IDG (the 121 MB grid) and
operations IDG-AW.  Cells ``idg.cycle`` and ``idg-aw.cycle``."""

from benchmark.metrics._util import kernel_share
from benchmark.reference import idg
from benchmark.roofline import idg_work


def _work(m, r):
    aw = "akerns" in r.step["inputs"]
    n_rec, n_runs = m.cached(r, "idg_runs", lambda req: idg.runs(
        req, m.cfg, m.device, aw, imaging=False))
    nant = len(r.req["akerns"]) if aw else 0
    return idg_work(n_rec, n_runs, m.cfg["subgrid"], m.grid_n, nant)


def read(m):
    return kernel_share(m, "idg_degrid", _work)
