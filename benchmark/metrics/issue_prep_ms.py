"""issue_prep_ms (ms, lower): host time of the program's spans
``sdp.device_prep`` per traced request: the part of ``host_issue_ms``
spent issuing the device prep (coordinates, weights, the w-plane search,
the run and tile preps), from the program's span log.  Every cell."""

from benchmark.metrics._spans import mean_ms, total_s


def read(m):
    return mean_ms(m, lambda root, kids: total_s(kids, "sdp.device_prep"))
