"""host_wait_ms (ms, lower): host time of a traced request's
``sdp.readback`` spans, the reads of results from the card (the dropped
count, the image maximum, the prediction's peak), which wait for the
device work before them; from the program's span log.  Every cell."""

from benchmark.metrics._spans import mean_ms, total_s


def read(m):
    return mean_ms(m, lambda root, kids: total_s(kids, "sdp.readback"))
