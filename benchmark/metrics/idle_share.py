"""idle_share (%, lower): 1 − (device busy time per traced request) ÷
(wall time per request of the same run's untraced window).  The profiler
adds host time to every call, so the wall is taken from the untraced
window.  Every cell."""


def read(m):
    if m.trace is None or not m.profiled or m.trace.busy_s <= 0:
        return None
    busy = m.trace.busy_s / len(m.profiled)
    wall = m.window_s / len(m.latencies_s)
    return 100.0 * (1.0 - busy / wall)
