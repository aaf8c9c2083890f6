"""fft_ms (ms, lower): cuFFT device time per request, from the traced
requests: the finish's centred FFTs (and a prediction's forward FFT of
the model).  Every cell."""

from benchmark.metrics._util import per_request_ms


def read(m):
    return per_request_ms(m, "fft")
