"""issue_finish_ms (ms, lower): host time of the program's spans
``sdp.finish`` per traced request: the part of ``host_issue_ms`` spent
issuing the finish (Hermitian, centred FFTs, taper, crop, the image's
maximum), from the program's span log.  Every cell; 0 in a prediction."""

from benchmark.metrics._spans import mean_ms, total_s


def read(m):
    return mean_ms(m, lambda root, kids: total_s(kids, "sdp.finish"))
