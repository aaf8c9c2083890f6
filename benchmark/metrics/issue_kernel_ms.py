"""issue_kernel_ms (ms, lower): host time of the program's spans
``sdp.kernel.<kernel>`` per traced request: the part of
``host_issue_ms`` spent launching the hand kernels (their checks, buffers
and ctypes calls), from the program's span log.  Every cell."""

from benchmark.metrics._spans import mean_ms, total_s


def read(m):
    return mean_ms(m, lambda root, kids: total_s(kids, "sdp.kernel."))
