"""request_ms_p95 (ms, lower): 95th percentile (linear interpolation) of
the time of every request in the window, each from the call until its
result is on the card.  Cells ``idg.cycle``, ``wproj.dumpcycle`` and
``wproj.fast``: ``idg-aw.cycle``'s host-bound requests spread too widely
for a bound (``PERF.md`` §2)."""

import numpy as np


def read(m):
    return 1e3 * float(np.percentile(m.latencies_s, 95))
