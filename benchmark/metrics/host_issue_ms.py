"""host_issue_ms (ms, lower): host time of a traced request's root span
less its ``sdp.host_prep`` and ``sdp.readback`` spans: the entry's Python
and launches issuing device prep, kernels and finish, from the program's
span log.  Every cell."""

from benchmark.metrics._spans import mean_ms, seconds, total_s


def read(m):
    return mean_ms(m, lambda root, kids: seconds(root)
                   - total_s(kids, "sdp.host_prep")
                   - total_s(kids, "sdp.readback"))
