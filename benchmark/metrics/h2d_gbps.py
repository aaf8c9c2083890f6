"""h2d_gbps (GB/s, higher): bytes the program copied from host memory to
the card in the traced requests (the ``h2d_bytes`` count of their root
spans) over the device time of the host-to-device copies in the same
requests (layer ``h2d`` of the device trace).  None without the span log
or without copies on the card.  Every cell."""

from benchmark.metrics._spans import requests


def read(m):
    reqs = requests(m)
    if reqs is None:
        return None
    copy_s = sum(r.device.get("h2d", 0.0) for r in m.profiled)
    if copy_s <= 0:
        return None
    return sum(root.counts.get("h2d_bytes", 0) for root, _ in reqs) \
        / copy_s / 1e9
