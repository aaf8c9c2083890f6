"""Reduced-precision numerics for gridding (port of
``ska_sdp_tpu/ops/lowprec.py``).

* a posit(16,1) codec in int32 tensor bit operations, the same on the CPU
  and on the card: :func:`p16_to_f32` / :func:`f32_to_p16` with the
  zero/NaR conventions, two's-complement negatives and round-to-nearest-
  even encoding that never rounds a nonzero value to zero or NaR;
* the bfloat16 and float8 (e4m3, e5m2) quantizers of complex data, with
  the reference's overflow semantics;
* :func:`gridding_quantization_error`: the relative RMS error of the
  dirty grid when each format quantizes the bank and the visibilities.

Powers of two are built from their float32 bits, never from a float
``exp2`` or ``log2``, so every decoded value is exact.
"""

from __future__ import annotations

import torch

_NAR = 0x8000
_MASK15 = 0x7FFF
_MASK16 = 0xFFFF
# e4m3fn has no infinity: ml_dtypes (the reference's cast) rounds to
# nearest even and gives NaN above the midpoint of 448 and the 480 its NaN
# code would stand for; torch's cast saturates to ±448 there instead
_E4M3_NAN_ABOVE = 464.0


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2**k`` for int32 ``k`` in [-126, 127]."""
    return ((k + 127) << 23).to(torch.int32).view(torch.float32)


def _highest_bit(z: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each int32 ``z`` in [0, 2**24), −1
    for 0 (``31 − clz(z)``): ``frexp`` of the value, exact below 2**24."""
    return (torch.frexp(z.to(torch.float64)).exponent - 1).to(torch.int32)


def p16_to_f32(p: torch.Tensor) -> torch.Tensor:
    """Decode posit(16,1) bit patterns (int32 holding uint16) to float32:
    0 → 0.0, NaR (0x8000) → NaN, else
    ``(−1)^s · 2^(2k+e) · (1 + f/2^nf)``."""
    p = torch.as_tensor(p).to(torch.int32) & _MASK16
    is_zero = p == 0
    is_nar = p == _NAR
    sign = (p >> 15) & 1
    mag = torch.where(sign == 1, (0x10000 - p) & _MASK16, p)
    bits = mag & _MASK15

    r0 = (bits >> 14) & 1
    run_of = torch.where(r0 == 1, bits, (~bits) & _MASK15)
    # the leading identical-bit run of the 15-bit field ends at the
    # highest zero of run_of
    hb = _highest_bit((~run_of) & _MASK15)
    m = 14 - hb
    k = torch.where(r0 == 1, m - 1, -m)

    rem = hb.clamp(min=0)                        # bits below the terminator
    e = torch.where(rem >= 1, (bits >> (rem - 1).clamp(min=0)) & 1, 0)
    nf = (rem - 1).clamp(min=0)
    frac = bits & ((1 << nf) - 1)

    val = (1.0 + frac.to(torch.float32) * _pow2(-nf)) * _pow2(2 * k + e)
    val = torch.where(sign == 1, -val, val)
    val = torch.where(is_zero, 0.0, val)
    return torch.where(is_nar, float("nan"), val)


def f32_to_p16(f: torch.Tensor) -> torch.Tensor:
    """Encode float32 to posit(16,1) bit patterns (int32) with
    round-to-nearest-even.  Nonzero normal values never round to zero
    (they clamp to ±minpos) nor to NaR (±maxpos); subnormals → 0, NaN and
    ±inf → NaR."""
    f = torch.as_tensor(f).to(torch.float32)
    is_nar = torch.isnan(f) | torch.isinf(f)
    sign = f < 0

    fb = torch.abs(f).contiguous().view(torch.int32)
    biased = (fb >> 23) & 0xFF
    mant = fb & 0x7FFFFF
    # zero, and subnormals as zero: the reference's comparison with 0.0
    # runs with denormals flushed (XLA on the CPU and the TPU)
    is_zero = biased == 0
    E = biased - 127

    k = E >> 1            # floor division (arithmetic shift)
    e = E - 2 * k         # in {0, 1}

    clamp_max = k >= 14
    clamp_min = k <= -15
    ksafe = k.clamp(-14, 13)

    regime_len = torch.where(ksafe >= 0, ksafe + 2, 1 - ksafe)
    pattern = torch.where(ksafe >= 0, ((1 << (ksafe + 1).clamp(min=0)) - 1)
                          << 1, 1)
    bits_after = 15 - regime_len                 # in [0, 13]
    ef = (e << 23) | mant                        # 24 payload bits
    shift = 24 - bits_after                      # in [11, 24]

    q = (pattern << bits_after) | (ef >> shift)
    r = ef & ((1 << shift) - 1)
    half = 1 << (shift - 1)
    round_up = (r > half) | ((r == half) & ((q & 1) == 1))
    q = q + round_up.to(torch.int32)
    # a carry through the regime is a valid neighbouring posit; clamp the
    # two poles: never 0 or 0x8000 for a nonzero input
    q = q.clamp(1, _MASK15)
    q = torch.where(clamp_max, _MASK15, q)
    q = torch.where(clamp_min, 1, q)

    p = torch.where(sign, (0x10000 - q) & _MASK16, q)
    p = torch.where(is_zero, 0, p)
    return torch.where(is_nar, _NAR, p).to(torch.int32)


def _per_part(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` on a real tensor, or on the real and imaginary parts of a
    complex one (float32 parts, a complex64 result)."""
    x = torch.as_tensor(x)
    if x.is_complex():
        return torch.complex(fn(x.real.to(torch.float32)),
                             fn(x.imag.to(torch.float32)))
    return fn(x)


def quantize_posit16(x: torch.Tensor) -> torch.Tensor:
    """Round real or complex data through posit(16,1), back to float32."""
    return _per_part(x, lambda r: p16_to_f32(f32_to_p16(r)))


def _nan_as(r: torch.Tensor, out: torch.Tensor, nan) -> torch.Tensor:
    """``out`` with a quiet NaN of ``r``'s sign where ``nan`` holds (the
    reference's casts give that NaN, whatever the input's payload)."""
    return torch.where(nan, torch.copysign(
        torch.full_like(out, float("nan")), r), out)


def quantize_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round real or complex data through bfloat16 (round to nearest
    even): complex → complex64, real → its own dtype."""
    def q(r):
        out = r.to(torch.bfloat16).to(r.dtype)
        return _nan_as(r, out, torch.isnan(r))

    return _per_part(x, q)


_F8 = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


def _to_f8(r: torch.Tensor, kind: str) -> torch.Tensor:
    nan = torch.isnan(r)
    if kind == "e4m3":
        nan |= torch.isinf(r) | (torch.abs(r) > _E4M3_NAN_ABOVE)
    return _nan_as(r, r.to(_F8[kind]).to(r.dtype), nan)


def quantize_f8(x: torch.Tensor, kind: str = "e4m3") -> torch.Tensor:
    """Round real or complex data through float8 ``e4m3`` (e4m3fn) or
    ``e5m2``, as the reference's cast does: round to nearest even; e4m3
    gives a NaN of the input's sign for |x| > 464 and ±inf, e5m2 goes to
    ±inf above its range."""
    if kind not in _F8:
        raise ValueError(f"unknown float8 kind {kind!r}")
    return _per_part(x, lambda r: _to_f8(r, kind))


QUANTIZERS = {
    "posit16": quantize_posit16,
    "bf16": quantize_bf16,
    "f8_e4m3": lambda x: quantize_f8(x, "e4m3"),
    "f8_e5m2": lambda x: quantize_f8(x, "e5m2"),
}


def gridding_quantization_error(bank, p, wbin, vis, grid_shape,
                                formats=None) -> dict[str, float]:
    """Relative RMS error of the dirty grid per format, the bank and the
    visibilities both quantized, against the complex64 grid:
    ``{format: rms(g_q − g) / rms(g)}`` (default formats bf16, posit16).

    Every grid is one bank scatter (``kernels.wproj_gridder``: on CUDA
    tensors ``csrc/wproj_grid.cu``, on CPU tensors its plain version) of
    the inputs' device; ``bank`` ``[nw, qpx, qpx, gh, gw]`` is applied as
    given."""
    from ..kernels.wproj import wproj_gridder

    formats = formats or ["bf16", "posit16"]
    bank = torch.as_tensor(bank).to(torch.complex64)
    vis = torch.as_tensor(vis).to(torch.complex64)

    def grid(b, v):
        return wproj_gridder(b, tuple(grid_shape), p, wbin, v).to(
            torch.complex128)

    ref = grid(bank, vis)
    ref_ms = torch.mean(torch.abs(ref) ** 2)
    out = {}
    for name in formats:
        q = QUANTIZERS[name]
        err = torch.mean(torch.abs(grid(q(bank), q(vis)) - ref) ** 2)
        out[name] = float(torch.sqrt(err / ref_ms))
    return out
