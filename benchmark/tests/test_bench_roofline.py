"""The rooflines' operation and byte counts against hand counts at tiny
shapes, and the reference's counts of the work these inputs need."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.reference import idg, wproj


def test_sandwich_takes_the_lesser_count():
    assert roofline.sandwich_flops(8) == 10 * 64 * 3 + 6 * 64       # 2304
    assert roofline.sandwich_flops(2) == 10 * 4 + 6 * 4
    assert roofline.sandwich_flops(64) == 10 * 4096 * 6 + 6 * 4096


def test_idg_work_by_hand():
    # 3 records in 2 subgrids of side 8 on a 16² grid, no screens
    assert roofline.idg_work(3, 2, 8, 16) == (8 * 64 * 3 + 2 * 2304,
                                              20 * 3 + 8 * 256)
    # with 4 stations' screens: 12·S² a run, the screens and pair ids
    assert roofline.idg_work(3, 2, 8, 16, nant=4) == (
        8 * 64 * 3 + 2 * (2304 + 12 * 64),
        20 * 3 + 8 * 256 + 8 * 4 * 64 + 8 * 2)


def test_wproj_work_and_least_time_by_hand():
    assert roofline.wproj_work(10, 2, 100, 4) == (80, 24 * 2 + 100 + 128)
    t, by = roofline.least_time(989e12, 1.0)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = roofline.least_time(1.0, 3.35e12)
    assert by == "bytes" and t == pytest.approx(1.0)


def _req(uvw, a1=None, a2=None):
    n = len(uvw)
    return {"uvw": np.asarray(uvw, np.float64), "vis": np.ones(n),
            "a1": np.zeros(n, np.int64) if a1 is None else np.asarray(a1),
            "a2": np.ones(n, np.int64) if a2 is None else np.asarray(a2),
            "time": np.arange(n, dtype=np.float64), "freq": 299792458.0}


CFG = {"theta": 0.05, "lam": 5120, "subgrid": 64, "support": 15,
       "taper_beta": 12.0}


def test_idg_runs_by_hand():
    # at f = c the uvw are wavelengths; the tile side is 2·13 − 2 = 24
    # cells, so records 0 and 1 (one cell apart) share a tile, record 2
    # lies far away
    uvw = [[10.0, 10.0, 0.0], [30.0, 10.0, 0.0], [1500.0, 900.0, 5.0]]
    dev = torch.device("cpu")
    assert idg.runs(_req(uvw), CFG, dev, aw=False) == (3, 2)
    # with A-terms, a second station pair in the first tile is a run more
    aw = _req(uvw, a1=[0, 1, 0], a2=[1, 2, 1])
    assert idg.runs(aw, CFG, dev, aw=True) == (3, 3)


def test_wproj_taps_by_hand():
    N = 256
    bank = torch.zeros((2, 4, 4, 15, 15), dtype=torch.complex64)
    req = _req([[0.0, 0.0, 0.0], [-N / 2 * 20.0, 0.0, 0.0]])
    req.update(wkerns=bank, wbins=np.array([-1.0, 1.0]))
    # the first patch lies inside; the second starts 7 columns left of
    # the grid's first column, so 8 of its 15 columns are inside
    assert wproj.taps(req, CFG, torch.device("cpu")) == 225 + 15 * 8


@pytest.mark.parametrize("name,layer", [
    # the port's own CUB plan (wproj_plan.cuh, aw_grid.cu): the hand layer
    ("void cub::CUB_200200_900_NS::DeviceRadixSortOnesweepKernel<cub::"
     "CUB_200200_900_NS::DeviceRadixSortPolicy<int, int, int>::Policy900, "
     "false, int, int, int, int>(int*, int*, int const*, int*, int*, int, "
     "int, int)", "hand"),
    ("void cub::CUB_200200_900_NS::DeviceRadixSortHistogramKernel<cub::"
     "CUB_200200_900_NS::DeviceRadixSortPolicy<int, int, unsigned int>"
     "::Policy900, false, int, unsigned int>(unsigned int*, int const*, "
     "unsigned int, int, int)", "hand"),
    ("void idg_grid_kernel<64>(float const*, long, int const*, int)", "hand"),
    # ATen's CUB (torch.sort, torch.unique): device prep
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail"
     "::cub::DeviceRadixSortPolicy<long, long, int>::Policy900, false, long, "
     "long, int, int>(int*, int*, long const*, long*, long const*, long*, "
     "int, int, int)", "aten"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul>)", "aten"),
    # cuFFT
    ("void regular_fft<256u, EPT<16u>, 16u, 16u, 4u, CallbackType>(...)",
     "fft"),
    ("void vector_fft<16u, EPT<4u>, 4u, 1u, 8u, padding_t>(...)", "fft"),
    ("spRadix0064B::kernel1Mem<unsigned int, float, fftDirection_t(1), 32u, "
     "4u, CONSTANT, ALL, WRITEBACK>(kernel_parameters_t<fft_mem_radix1_t, "
     "unsigned int, float>)", "fft"),
    ("Memcpy HtoD (Pageable -> Device)", "h2d"),
])
def test_layer_table_sorts_cub_sorts_apart_from_cufft(name, layer):
    from benchmark import trace
    layers = trace.load_layers(trace.Path(roofline.__file__).parent)
    assert trace.classify(name, layers) == layer
