"""host_prep_ms (ms, lower): host time of the program's span
``sdp.host_prep`` per traced request (the host inputs: casts, the A-term
screens, the pair count, the raster check and the copies to the card),
from the program's span log.  Every cell."""

from benchmark.metrics._spans import mean_ms, total_s


def read(m):
    return mean_ms(m, lambda root, kids: total_s(kids, "sdp.host_prep"))
