"""h2d_ms (ms, lower): device time of host-to-device copies per request,
from the traced requests (layer ``h2d`` of ``layers.json``).  It reads the
host-prep layer: the program's own input helpers copy the records, the
model and the screens to the card on every call.  Every cell."""

from benchmark.metrics._util import per_request_ms


def read(m):
    return per_request_ms(m, "h2d")
