"""Port parity for the reduced-precision study (``ops/lowprec.py``).

Inputs come from numpy with a seed and go to both packages (JAX on the
CPU, x64).  Bounds:

* bit for bit: the posit(16,1) decode of all 65,536 patterns and the
  encode back (the identity); the encode of a sample spanning the posit
  range, zeros, subnormals, ±inf, NaN and raw bit patterns; the bf16, e4m3
  and e5m2 quantizers of float32 and complex64 data on that sample, e4m3's
  overflow to NaN included (NaNs compared by their bits too);
* the reference test's known values, NaR, two's-complement negatives,
  never-to-zero and round-to-nearest-even cases, each also equal to JAX;
* 1% per format: ``gridding_quantization_error`` against JAX's, with
  posit16 < bf16 < 0.02 as the reference test asserts.

The ``cuda`` tests hold the codec and the quantizers on the card to the
CPU bit for bit, and the study's scatter (``csrc/wproj_grid.cu``) to the
plain scatter within rel-L2 5e-5; they skip without a card.
"""

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch.ops import lowprec

torch.set_num_threads(2)

CUDA_TOL = 5e-5
OVERFLOW = [448.0, 463.99, 464.0, 465.0, 480.0, -500.0, 1e4, 7e4, 6e4,
            57344.0, 61440.0, 61441.0, 1e6, np.inf, -np.inf, np.nan, -np.nan]


@pytest.fixture(scope="module")
def j():
    """The JAX reference, imported only by the tests that compare with it,
    so the ``cuda`` tests also run where jax is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from ska_sdp_tpu.ops import lowprec as jl

    return jnp, jl


def _sample(n: int, seed: int) -> np.ndarray:
    """float32 values over the posit range and beyond, zeros, subnormals,
    the overflow values, ±inf, NaNs and raw bit patterns."""
    rng = np.random.default_rng(seed)
    spread = (rng.standard_normal(n) * np.exp2(rng.uniform(-40, 40, n))
              ).astype(np.float32)
    raw = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    sub = (rng.uniform(-1, 1, n // 8) * 1.1e-38).astype(np.float32)
    fixed = np.array([0.0, -0.0, 1e-45, -1e-45, 1.0, -1.0, 2.0 ** 28,
                      2.0 ** -28, 3.4e38] + OVERFLOW, np.float32)
    return np.concatenate([spread, raw, sub, fixed])


def _complex(x: np.ndarray) -> np.ndarray:
    """complex64 with ``x`` as its real parts and ``x`` reversed as its
    imaginary parts, each part exactly as given."""
    c = np.empty(x.shape, np.complex64)
    c.real, c.imag = x, x[::-1]
    return c


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.float32).view(np.uint32) if a.dtype.kind in "fc" \
        else a


class TestPosit16:
    def test_exhaustive_roundtrip_matches_jax(self, j):
        jnp, jl = j
        pats = np.arange(65536, dtype=np.int32)
        vals = lowprec.p16_to_f32(torch.from_numpy(pats)).numpy()
        np.testing.assert_array_equal(
            _bits(vals), _bits(np.asarray(jl.p16_to_f32(jnp.asarray(pats)))))
        back = lowprec.f32_to_p16(torch.from_numpy(vals)).numpy()
        np.testing.assert_array_equal(back & 0xFFFF, pats)
        np.testing.assert_array_equal(
            back, np.asarray(jl.f32_to_p16(jnp.asarray(vals))))

    def test_encode_sample_matches_jax(self, j):
        jnp, jl = j
        x = _sample(50_000, 1)
        np.testing.assert_array_equal(
            lowprec.f32_to_p16(torch.from_numpy(x)).numpy(),
            np.asarray(jl.f32_to_p16(jnp.asarray(x))))

    @pytest.mark.parametrize("pattern,value", [
        (0x0000, 0.0), (0x4000, 1.0), (0x7FFF, 2.0 ** 28),
        (0x0001, 2.0 ** -28), (0xC000, -1.0), (0x8001, -(2.0 ** 28))])
    def test_known_values(self, j, pattern, value):
        jnp, jl = j
        got = lowprec.p16_to_f32(torch.tensor([pattern])).numpy()
        assert got[0] == value
        assert got[0] == np.asarray(jl.p16_to_f32(jnp.asarray([pattern])))[0]

    @pytest.mark.parametrize("value,pattern", [
        (np.nan, 0x8000), (np.inf, 0x8000), (-np.inf, 0x8000),
        (-1.0, 0xC000),                        # two's complement of 0x4000
        (1e-30, 0x0001), (-1e-30, 0xFFFF),     # ±minpos, never zero
        (1e30, 0x7FFF), (-1e30, 0x8001),       # ±maxpos, never NaR
        (1.0 + 2.0 ** -14, 0x4000),            # round to nearest even
        (0.0, 0x0000)])
    def test_encode_cases(self, j, value, pattern):
        jnp, jl = j
        x = np.asarray([value], np.float32)
        got = int(lowprec.f32_to_p16(torch.from_numpy(x))[0]) & 0xFFFF
        assert got == pattern
        assert got == int(jl.f32_to_p16(jnp.asarray(x))[0]) & 0xFFFF

    def test_nar_decodes_to_nan(self):
        assert torch.isnan(lowprec.p16_to_f32(torch.tensor([0x8000])))[0]

    def test_random_roundtrip_accuracy(self):
        # 12 fraction bits near 1
        x = np.random.default_rng(42).uniform(0.5, 2.0, 1000).astype(
            np.float32)
        y = lowprec.quantize_posit16(torch.from_numpy(x)).numpy()
        assert (np.abs(y - x) / x).max() < 2.0 ** -12


class TestQuantizers:
    @pytest.mark.parametrize("name", sorted(lowprec.QUANTIZERS))
    @pytest.mark.parametrize("dtype", [np.float32, np.complex64])
    def test_bit_equal_to_jax(self, j, name, dtype):
        jnp, jl = j
        x = _sample(40_000, 2)
        if dtype == np.complex64:
            x = _complex(x)
        got = lowprec.QUANTIZERS[name](torch.from_numpy(x)).numpy()
        ref = np.asarray(jl.QUANTIZERS[name](jnp.asarray(x)))
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(_bits(got), _bits(ref))

    def test_e4m3_overflow_is_nan(self):
        x = torch.tensor([463.99, 464.0, 465.0, -500.0, float("inf")])
        got = lowprec.quantize_f8(x, "e4m3")
        assert got[:2].tolist() == [448.0, 448.0]
        assert torch.isnan(got[2:]).all()
        assert torch.signbit(got[3])

    def test_bf16_complex_accuracy(self):
        rng = np.random.default_rng(3)
        c = (rng.standard_normal(50) + 1j * rng.standard_normal(50)
             ).astype(np.complex64)
        q = lowprec.quantize_bf16(torch.from_numpy(c)).numpy()
        assert (np.abs(q - c) / np.abs(c)).max() < 2.0 ** -7


def _study_inputs(seed: int, nw=2, qpx=2, s=7, b=64):
    rng = np.random.default_rng(seed)
    bank = (rng.standard_normal((nw, qpx, qpx, s, s))
            + 1j * rng.standard_normal((nw, qpx, qpx, s, s))).astype(
                np.complex64)
    p = rng.uniform(-0.3, 0.3, (b, 3)).astype(np.float32)
    wbin = rng.integers(0, nw, b).astype(np.int32)
    vis = (rng.standard_normal(b) + 1j * rng.standard_normal(b)).astype(
        np.complex64)
    return bank, p, wbin, vis


class TestErrorStudy:
    def test_matches_jax(self, j):
        jnp, jl = j
        bank, p, wbin, vis = _study_inputs(42)
        formats = sorted(lowprec.QUANTIZERS)
        got = lowprec.gridding_quantization_error(
            torch.from_numpy(bank), torch.from_numpy(p),
            torch.from_numpy(wbin), torch.from_numpy(vis), (64, 64),
            formats=formats)
        ref = jl.gridding_quantization_error(
            bank, jnp.asarray(p), jnp.asarray(wbin), jnp.asarray(vis),
            (64, 64), formats=formats)
        for name in formats:
            assert got[name] == pytest.approx(ref[name], rel=0.01), name
        # posit16 (12 fraction bits near 1) beats bf16 (8) on unit-scale
        # data
        assert got["posit16"] < got["bf16"] < 0.02

    def test_default_formats(self):
        bank, p, wbin, vis = _study_inputs(5)
        got = lowprec.gridding_quantization_error(
            torch.from_numpy(bank), torch.from_numpy(p),
            torch.from_numpy(wbin), torch.from_numpy(vis), (64, 64))
        assert sorted(got) == ["bf16", "posit16"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    def test_codec_bit_equal_to_cpu(self, cuda_device):
        pats = torch.arange(65536, dtype=torch.int32)
        dec = lowprec.p16_to_f32(pats.to(cuda_device)).cpu()
        assert torch.equal(dec.view(torch.int32),
                           lowprec.p16_to_f32(pats).view(torch.int32))
        x = torch.from_numpy(_sample(100_000, 4))
        assert torch.equal(lowprec.f32_to_p16(x.to(cuda_device)).cpu(),
                           lowprec.f32_to_p16(x))

    @pytest.mark.parametrize("name", sorted(lowprec.QUANTIZERS))
    def test_quantizers_bit_equal_to_cpu(self, cuda_device, name):
        x = _sample(100_000, 5)
        c = torch.from_numpy(_complex(x))
        got = lowprec.QUANTIZERS[name](c.to(cuda_device)).cpu()
        ref = lowprec.QUANTIZERS[name](c)
        assert torch.equal(torch.view_as_real(got).view(torch.int32),
                           torch.view_as_real(ref).view(torch.int32))

    def test_study_scatter_matches_plain(self, cuda_device):
        from ska_sdp_tpu_torch.kernels import wproj
        from ska_sdp_tpu_torch.ops.gridding import convgrid_wproj

        bank, p, wbin, vis = _study_inputs(6, nw=4, qpx=4, s=9, b=20_000)
        args = [torch.from_numpy(a).to(cuda_device)
                for a in (bank, p, wbin, vis)]
        wproj.reset_launch_count()
        errs = lowprec.gridding_quantization_error(
            *args, (256, 256), formats=sorted(lowprec.QUANTIZERS))
        assert wproj.launch_count(wproj.GRID_KERNEL) == 5
        cpu = lowprec.gridding_quantization_error(
            *[torch.from_numpy(a) for a in (bank, p, wbin, vis)],
            (256, 256), formats=sorted(lowprec.QUANTIZERS))
        for name, q in lowprec.QUANTIZERS.items():
            b_q, v_q = q(args[0]), q(args[3])
            k = wproj.wproj_gridder(b_q, (256, 256), args[1], args[2], v_q)
            pl = convgrid_wproj(b_q, torch.zeros_like(k), args[1], args[2],
                                v_q)
            rel = float(torch.linalg.norm(k - pl) / torch.linalg.norm(pl))
            assert rel <= CUDA_TOL, name
            assert errs[name] == pytest.approx(cpu[name], rel=0.01), name
