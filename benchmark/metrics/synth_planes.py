"""synth_planes (planes, lower): w-kernel planes synthesised per traced
request, the ``wkernel_planes`` count of the requests' root spans (a bank
for the image and another for the PSF).  None where the program counts
none.  Cell ``wcache.psf``."""

from benchmark.metrics._spans import requests


def read(m):
    reqs = requests(m)
    if reqs is None or any("wkernel_planes" not in r.counts
                           for r, _ in reqs):
        return None
    return sum(r.counts["wkernel_planes"] for r, _ in reqs) / len(reqs)
