"""aten_ms (ms, lower): device time of PyTorch's own kernels (ATen, and
the CUB kernels under ``at_cuda_detail``) per request, from the traced
requests.  It reads the device-prep layer: uvw scaling, uniform weights,
mirroring, the w-plane search, the run tables.  Every cell."""

from benchmark.metrics._util import per_request_ms


def read(m):
    return per_request_ms(m, "aten")
