"""issue_synth_ms (ms, lower): host time of the program's spans
``sdp.wkernel`` per traced request: issuing the w-kernel synthesis of the
banks a request builds (screens, padding, the centred inverse FFTs and
the taps), from the program's span log.  None where the program logs no
such span.  Cell ``wcache.psf``."""

from benchmark.metrics._spans import requests, total_s


def read(m):
    reqs = requests(m)
    if reqs is None or not any(s.name == "sdp.wkernel"
                               for _, kids in reqs for s in kids):
        return None
    return 1e3 * sum(total_s(k, "sdp.wkernel") for _, k in reqs) / len(reqs)
