"""Port parity: the streamed IDG(-AW) gridder against the JAX reference's
``idg_aw_gridder_stream`` run as its own tests run it on the CPU (Pallas
interpret mode), pinned to the ``exact`` precision tier — the tier whose
operator (full float32) the port implements.

Bound: grid rel-L2 ≤ 5e-5 with equal ``n_dropped`` — the bound the
reference's own tests allow between two routes to this operator.  The
port is checked both on the reference prep's records
(``from_jax_run_records``: kernel parity alone) and through its own prep.

On the CPU the wrapper takes the plain version; the CUDA kernel itself is
checked by the ``cuda``-marked tests, which skip without a card.  The
kernel's split-fp16 tensor-core arithmetic is emulated here on the CPU and
held to float64 within 1e-6 (``TestSplitF16Numerics``); its block order
is held to its plain version (``TestRunOrder``).
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch import kernels
from ska_sdp_tpu_torch.kernels import idg_aw_stream
from ska_sdp_tpu_torch.kernels.idg_aw_records import idg_aw_run_records
from ska_sdp_tpu_torch.ops.idg import _dft_matrix, kaiser_taper
from ska_sdp_tpu_torch.ops.idg_aw import PAIR_SHIFT, SENTINEL, aw_screens_host
from ska_sdp_tpu_torch.utils import timing
from torch_jax_records import from_jax_run_records

torch.set_num_threads(2)

N, THETA, SA = 256, 0.05, 64
UNIT_RUNS = ((N + 2 * SA) // 24 + 2) ** 2 + 64
TOL = 5e-5


def track_problem(rng, nant=6, ntime=48, nchan=4, wmax=250.0):
    """Baseline-track records, time-major across baselines with channels
    inner: per-pair smooth uv drift, as interferometer data is laid out."""
    pairs = [(i, j) for i in range(nant) for j in range(i + 1, nant)]
    nbl = len(pairs)
    u0 = rng.uniform(-0.30, 0.30, (nbl, 2))
    du = rng.uniform(-15.0 / N, 15.0 / N, (nbl, 2))
    w0 = rng.uniform(-wmax, wmax, nbl)
    dw = rng.uniform(-20.0, 20.0, nbl)
    fscale = 1.0 + 0.002 * np.arange(nchan)
    t = np.arange(ntime)[:, None, None] / ntime
    uv = u0[None, :, None, :] + du[None, :, None, :] * t[..., None]
    uv = uv * fscale[None, None, :, None]                 # [t, b, c, 2]
    shape = (ntime, nbl, nchan)
    p = np.zeros(shape + (3,), np.float32)
    p[..., :2] = uv
    w = np.broadcast_to((w0[None, :] + dw[None, :] * t[..., 0])[..., None],
                        shape)
    a1 = np.broadcast_to(np.array([i for i, _ in pairs])[None, :, None],
                         shape)
    a2 = np.broadcast_to(np.array([j for _, j in pairs])[None, :, None],
                         shape)
    n = int(np.prod(shape))
    vis = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
           ).astype(np.complex64)
    return (p.reshape(n, 3), w.reshape(n).astype(np.float32),
            a1.reshape(n).astype(np.int32), a2.reshape(n).astype(np.int32),
            vis)


def random_problem(rng, b=3000, extent=0.45):
    p = np.zeros((b, 3), np.float32)
    p[:, :2] = rng.uniform(-extent, extent, (b, 2))
    w = rng.uniform(-250.0, 250.0, b).astype(np.float32)
    vis = (rng.standard_normal(b) + 1j * rng.standard_normal(b)
           ).astype(np.complex64)
    zer = np.zeros(b, np.int32)
    return p, w, zer, zer.copy(), vis


@pytest.fixture(scope="module")
def jref():
    """The JAX reference, imported only by the tests that compare with it,
    so the ``cuda`` tests also run where jax is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from ska_sdp_tpu.kernels import _idg_unit_run_bound
    from ska_sdp_tpu.kernels.idg_aw_pallas import idg_aw_run_records
    from ska_sdp_tpu.kernels.idg_aw_stream_pallas import (
        _dft_factors, idg_aw_gridder_stream)

    return SimpleNamespace(jnp=jnp, run_records=idg_aw_run_records,
                           gridder=idg_aw_gridder_stream,
                           dft_factors=_dft_factors,
                           unit_run_bound=_idg_unit_run_bound)


@pytest.fixture
def exact_tier(monkeypatch, jref):
    monkeypatch.setenv("SKA_SDP_TPU_IDG_AW_PRECISION", "exact")
    return jref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _screens(rng, nant, S=SA):
    ak = np.zeros((nant, 5, 5), np.complex128)
    ak[:, 2, 2] = 1.0
    ak += 0.05 * (rng.standard_normal((nant, 5, 5))
                  + 1j * rng.standard_normal((nant, 5, 5)))
    return aw_screens_host(ak, S).astype(np.complex64)


def _jax_grid(jref, p, w, a1, a2, vis, scr, max_runs):
    jnp = jref.jnp
    g, nd = jref.gridder((N, N), jnp.asarray(p), jnp.asarray(a1),
                         jnp.asarray(a2), jnp.asarray(w), jnp.asarray(vis),
                         jnp.asarray(scr), theta=THETA, subgrid=SA,
                         max_runs=max_runs, interpret=True)
    return np.asarray(g), int(nd)


def _port_grid(p, w, a1, a2, vis, scr, max_runs, device="cpu"):
    g, nd = idg_aw_stream.idg_aw_gridder_stream(
        (N, N), torch.as_tensor(p, device=device),
        torch.as_tensor(a1, device=device),
        torch.as_tensor(a2, device=device),
        torch.as_tensor(w, device=device),
        torch.as_tensor(vis, device=device),
        torch.as_tensor(scr, device=device), theta=THETA, subgrid=SA,
        max_runs=max_runs)
    return g.cpu().numpy(), int(nd)


class TestPlainGridderParity:
    def test_unit_screens_random_uv(self, exact_tier):
        rng = np.random.default_rng(21)
        p, w, a1, a2, vis = random_problem(rng)
        scr = np.ones((1, SA, SA), np.complex64)
        want, nd_want = _jax_grid(exact_tier, p, w, a1, a2, vis, scr,
                                  UNIT_RUNS)
        idg_aw_stream.reset_launch_count()
        got, nd_got = _port_grid(p, w, a1, a2, vis, scr, UNIT_RUNS)
        assert nd_got == nd_want == 0
        assert _rel(got, want) < TOL
        # on the reference prep's records (blocks layout): kernel parity
        jnp = exact_tier.jnp
        recs = exact_tier.run_records(
            (N, N), jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2),
            jnp.asarray(w), jnp.asarray(vis.real), jnp.asarray(vis.imag),
            max_runs=UNIT_RUNS, nant=1)
        rr = from_jax_run_records(*[np.asarray(x) for x in recs[:8]])
        g2 = idg_aw_stream.idg_aw_grid_from_records_stream(
            *rr[:7], (N, N), torch.as_tensor(scr), theta=THETA, subgrid=SA)
        assert _rel(g2.numpy(), want) < TOL
        # a CPU tensor takes the plain version: the kernel never launched
        assert idg_aw_stream.launch_count() == 0

    def test_random_screens_track_data(self, exact_tier):
        rng = np.random.default_rng(22)
        p, w, a1, a2, vis = track_problem(rng, nant=6, ntime=64)
        scr = _screens(rng, 6)
        want, nd_want = _jax_grid(exact_tier, p, w, a1, a2, vis, scr, 4096)
        # through the port's own prep
        got, nd_got = _port_grid(p, w, a1, a2, vis, scr, 4096)
        assert nd_got == nd_want == 0
        assert _rel(got, want) < TOL
        # on the reference prep's records: kernel parity alone
        jnp = exact_tier.jnp
        recs = exact_tier.run_records(
            (N, N), jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2),
            jnp.asarray(w), jnp.asarray(vis.real), jnp.asarray(vis.imag),
            max_runs=4096, nant=6, layout="rows")
        rr = from_jax_run_records(*[np.asarray(x) for x in recs[:8]])
        g2 = idg_aw_stream.idg_aw_grid_from_records_stream(
            *rr[:7], (N, N), torch.as_tensor(scr), theta=THETA, subgrid=SA)
        assert int(rr[7]) == nd_want
        assert _rel(g2.numpy(), want) < TOL

    def test_dropped_records_match(self, exact_tier):
        # a run table too small for the data: overflow drops must agree
        rng = np.random.default_rng(23)
        p, w, a1, a2, vis = track_problem(rng, nant=4, ntime=48)
        scr = _screens(rng, 4)
        want, nd_want = _jax_grid(exact_tier, p, w, a1, a2, vis, scr, 4)
        got, nd_got = _port_grid(p, w, a1, a2, vis, scr, 4)
        assert nd_got == nd_want > 0
        assert _rel(got, want) < TOL


class TestGridderPieces:
    @pytest.mark.parametrize("S", [32, 64, 128])
    def test_dft_factors(self, S, jref):
        F, FT = idg_aw_stream._dft_factors(S, 12.0)
        want = jref.dft_factors(S, 12.0)[0]
        assert np.abs(F.numpy() - want).max() < 1e-7
        np.testing.assert_array_equal(FT.numpy(), F.numpy().T)

    def test_plain_grid_is_linear_and_placed(self):
        # one record at the centre of a tile: its patch sits at the run's
        # origin, and doubling the visibility doubles the grid
        S = SA
        recs = torch.zeros((5, 1))
        recs[3, 0] = 1.0
        one = torch.ones((1,), dtype=torch.int32)
        zero = torch.zeros((1,), dtype=torch.int32)
        y0 = torch.tensor([100], dtype=torch.int32)
        x0 = torch.tensor([40], dtype=torch.int32)
        scr = torch.ones((1, S, S), dtype=torch.complex64)
        kw = dict(grid_shape=(N, N), theta=THETA, subgrid=S)
        g = idg_aw_stream.grid_from_records_plain(
            recs, zero, one, y0, x0, zero, zero, scr, **kw)
        nz = torch.nonzero(g.abs() > 0)
        assert nz[:, 0].min() >= 100 and nz[:, 0].max() < 100 + S
        assert nz[:, 1].min() >= 40 and nz[:, 1].max() < 40 + S
        peak = torch.argmax(g.abs())
        assert divmod(int(peak), N + 2 * S) == (100 + S // 2, 40 + S // 2)
        recs[3, 0] = 2.0
        g2 = idg_aw_stream.grid_from_records_plain(
            recs, zero, one, y0, x0, zero, zero, scr, **kw)
        torch.testing.assert_close(g2, 2 * g)

    def test_kernel_input_checks(self):
        S = SA
        recs = torch.zeros((5, 10))
        runs = tuple(torch.zeros((4,), dtype=torch.int32) for _ in range(6))
        scr = torch.ones((1, S, S), dtype=torch.complex64)
        idg_aw_stream._check_cuda_inputs(recs, runs, scr, S)
        with pytest.raises(ValueError):
            idg_aw_stream._check_cuda_inputs(recs.double(), runs, scr, S)
        with pytest.raises(ValueError):
            idg_aw_stream._check_cuda_inputs(recs[:4], runs, scr, S)
        with pytest.raises(ValueError):
            idg_aw_stream._check_cuda_inputs(
                recs, runs[:5] + (runs[5].long(),), scr, S)
        with pytest.raises(ValueError):
            idg_aw_stream._check_cuda_inputs(recs, runs, scr[:, :32], S)
        with pytest.raises(ValueError):
            idg_aw_stream._check_cuda_inputs(recs.t().contiguous().t(),
                                             runs, scr, S)

    def test_subgrid_envelope_and_padding(self):
        # any even S from 2 to 128 reaches a kernel instance of side
        # 16·⌈S/16⌉; the wrappers zero-pad the screens (and planes) to it
        for S in range(2, 129, 2):
            idg_aw_stream.check_subgrid(S)
            SP = idg_aw_stream.padded_side(S)
            assert SP % 16 == 0 and S <= SP < S + 16
        assert [idg_aw_stream.padded_side(S) for S in (32, 64, 128)] == [
            32, 64, 128]
        for S in (0, 31, 33, 130):
            with pytest.raises(ValueError, match="subgrid"):
                idg_aw_stream.check_subgrid(S)
        scr = torch.randn((3, 20, 20), dtype=torch.complex64)
        p = idg_aw_stream._padded_screens(scr, 20)
        assert p.shape == (3, 32, 32) and torch.equal(p[:, :20, :20], scr)
        assert not p[:, 20:].any() and not p[:, :, 20:].any()
        unit = torch.ones((1, 64, 64), dtype=torch.complex64)
        assert idg_aw_stream._padded_screens(unit, 64) is unit
        # a CUDA launch at an odd or oversize subgrid is refused before the
        # kernel: the check comes first
        recs = torch.zeros((5, 4))
        runs = tuple(torch.zeros((2,), dtype=torch.int32) for _ in range(6))
        with pytest.raises(ValueError, match="subgrid"):
            idg_aw_stream._grid_from_records_cuda(
                recs, *runs, torch.ones((1, 33, 33), dtype=torch.complex64),
                grid_shape=(N, N), theta=THETA, subgrid=33, taper_beta=12.0)


def _planes(x):
    """The kernel's split of a float32 tensor: float32 values of its fp16
    planes ``hi = fp16(x)``, ``lo = fp16(x − hi)``."""
    x = x.to(torch.float32)
    hi = x.to(torch.float16).float()
    return hi, (x - hi).to(torch.float16).float()


def _real3(a, b):
    """A real product as the kernel's three fp16 passes (hi·hi, hi·lo,
    lo·hi) with float32 sums; ``a`` and ``b`` are (hi, lo) pairs.  Products
    of fp16 values are exact in float32, so a float32 matmul emulates one
    pass of ``mma.sync`` up to the order of the sums."""
    return a[0] @ b[0] + a[0] @ b[1] + a[1] @ b[0]


def _complex3(a, b):
    """A complex product on split planes, stacked over the depth as the
    kernel stacks it: re = [a_re | −a_im]·[b_re ; b_im], im = [a_re | a_im]
    ·[b_im ; b_re]; ``a``, ``b`` are (re pair, im pair)."""
    (ar, ai), (br, bi) = a, b

    def cat(x, y, dim):
        return tuple(torch.cat([x[i], y[i]], dim) for i in range(2))

    re = _real3(cat(ar, tuple(-x for x in ai), 1), cat(br, bi, 0))
    im = _real3(cat(ar, ai, 1), cat(bi, br, 0))
    return torch.complex(re, im)


def _split_c(z):
    return _planes(z.real), _planes(z.imag)


def _exponent(z):
    """e with max(|re|, |im|) < 2^e, as the kernel's frexp."""
    m = float(torch.maximum(z.real.abs(), z.imag.abs()).max())
    return math.frexp(m)[1]


def _long_run(S, nb=2242, seed=0):
    """One run of ``nb`` records at the main path's phase range (|dy|,
    |dx| < S/2 − 8 cells (S/4 below S = 32), |w| ≤ 100,000 λ at θ = 0.008:
    |ph| to ~110 rad), visibilities of order 1e3: ``(v [b], u [b, S], e_x
    [b, S])`` complex64 from the plain version's phase factors."""
    rng = np.random.default_rng(seed)
    d = max(S / 2 - 8, S / 4)
    dy, dx = (torch.as_tensor(rng.uniform(-d, d, nb).astype(np.float32))
              for _ in range(2))
    w = torch.as_tensor(rng.uniform(-1e5, 1e5, nb).astype(np.float32))
    v = torch.as_tensor((1e3 * (rng.standard_normal(nb)
                                + 1j * rng.standard_normal(nb))
                         ).astype(np.complex64))
    ey, ex = idg_aw_stream._phase_factors(S, 0.008, 0.008,
                                          torch.device("cpu"))(dy, dx, w)
    return v, v[:, None] * ey, ex


def _factor64(S, beta=12.0):
    """The taper-folded DFT factor F in float64."""
    return (_dft_matrix(S, torch.complex128) / S
            * kaiser_taper(S, beta, torch.float64)[None, :])


def _pad(x, SP, dims=(-2, -1)):
    """``x`` zero-padded to SP along ``dims``, as the kernels hold an S×S
    operand on the instance of side SP."""
    pad = [0, 0] * x.dim()
    for d in dims:
        pad[2 * (x.dim() - 1 - d % x.dim()) + 1] = SP - x.shape[d]
    return torch.nn.functional.pad(x, pad)


def _crop_padded(x, S):
    """The S×S corner of an emulated SP×SP result, checking that the rest
    is exactly 0."""
    assert not x[S:].any() and not x[:, S:].any()
    return x[:S, :S]


# 32, 64, 128: their own kernel instances; 16, 48, 96: emulated on the
# padded side 16·⌈S/16⌉ (48 and 96 are their own padded sides, with one
# warp and two warps across; 16 the smallest)
SPLIT_SUBGRIDS = [32, 64, 128, 16, 48, 96]


SPLIT_TOL = 1e-6     # ~3e-7 of float64; split-bf16 gives 4e-6–6e-6


class TestSplitF16Numerics:
    """The CUDA gridder's arithmetic, emulated on the CPU: its products
    (the accumulation a = u·e_xᵀ and the sandwich F·t·Fᵀ) on split-fp16
    planes of operands scaled by powers of two below 16, three passes each,
    float32 sums, against float64; on the kernel instance's side SP, with
    the operands zero from S on where SP > S."""

    @pytest.mark.parametrize("S", SPLIT_SUBGRIDS)
    def test_accumulation(self, S):
        SP = idg_aw_stream.padded_side(S)
        v, u, ex = _long_run(S, seed=S)
        want = u.to(torch.complex128).T @ ex.to(torch.complex128)
        u, ex = _pad(u, SP, (1,)), _pad(ex, SP, (1,))   # zero rows q ≥ S
        got = torch.zeros((SP, SP), dtype=torch.complex64)
        for c0 in range(0, v.shape[0], 32):       # the kernel's chunks
            e = _exponent(v[c0:c0 + 32])
            us = u[c0:c0 + 32] * 2.0 ** (3 - e)
            for k0 in range(0, us.shape[0], 16):  # its 16-deep steps
                part = _complex3(_split_c(us[k0:k0 + 16].T.contiguous()),
                                 _split_c(ex[c0 + k0:c0 + k0 + 16]))
                got += part * 2.0 ** (e - 3)
        got = _crop_padded(got, S)
        assert _rel(got.numpy(), want.numpy()) < SPLIT_TOL

    @pytest.mark.parametrize("S", SPLIT_SUBGRIDS)
    def test_sandwich(self, S):
        SP = idg_aw_stream.padded_side(S)
        _, u, ex = _long_run(S, seed=S + 1)
        a = (u.to(torch.complex128).T @ ex.to(torch.complex128))
        rng = np.random.default_rng(S)
        scr = idg_aw_stream._padded_screens(
            torch.as_tensor(_screens(rng, 2, S)), S)
        t = _pad(a.to(torch.complex64), SP) * torch.conj(scr[0] * scr[1])
        F = _factor64(S)
        want = F @ t[:S, :S].to(torch.complex128) @ F.T
        P = idg_aw_stream._dft_planes(S, 12.0).float()  # 16·S·F, padded
        f = ((P[0], P[1]), (P[2], P[3]))
        fT = tuple(tuple(x.T for x in pair) for pair in f)
        e_t = _exponent(t)
        B = _complex3(f, _split_c(t * 2.0 ** (4 - e_t)))
        got = _complex3(_split_c(B), fT) * 2.0 ** (e_t - 12) / (S * S)
        got = _crop_padded(got, S)
        assert _rel(got.numpy(), want.numpy()) < SPLIT_TOL

    @pytest.mark.parametrize("S", SPLIT_SUBGRIDS)
    def test_dft_planes_split_the_float64_factor(self, S):
        SP = idg_aw_stream.padded_side(S)
        F = _factor64(S) * (16 * S)
        P = idg_aw_stream._dft_planes(S, 12.0)
        assert P.dtype == torch.float16 and P.shape == (4, SP, SP)
        assert P.is_contiguous()
        assert not P[:, S:].any() and not P[:, :, S:].any()
        for k, part in ((0, F.real), (2, F.imag)):
            assert float(part.abs().max()) <= 16
            assert torch.equal(P[k, :S, :S], part.to(torch.float16))
            err = (P[k, :S, :S].double() + P[k + 1, :S, :S].double()
                   - part).abs().max()
            assert float(err) <= 2.0 ** -21 * float(part.abs().max())


class TestRunOrder:
    def test_random_table(self):
        rng = np.random.default_rng(41)
        lengths = rng.integers(1, 3000, 700)
        lengths[rng.random(700) < 0.3] = 0
        ext = np.concatenate([[0], np.cumsum(lengths)])
        starts = torch.as_tensor(ext[:-1].astype(np.int32))
        ends = torch.as_tensor(ext[1:].astype(np.int32))
        self._check(starts, ends)

    def test_prep_table(self):
        # the prep's table: occupied runs, sentinel runs, trailing empties
        rng = np.random.default_rng(42)
        p, w, a1, a2, vis = track_problem(rng, nant=5, ntime=40)
        recs = idg_aw_run_records(
            (N, N), *(torch.as_tensor(x) for x in (p, a1, a2, w, vis.real,
                                                   vis.imag)),
            max_runs=4096, nant=5)
        starts, ends = recs[1], recs[2]
        assert int((ends <= starts).sum()) > 0
        self._check(starts, ends)

    def test_length_class(self):
        # brute force: 4 classes per octave, by the two bits below the
        # leading one; 0 for empty (or inverted) entries
        n = np.array([-3, 0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 12, 567, 2242,
                      25000, 2**20 + 5, 2**31 - 1])
        want = []
        for v in n:
            if v <= 0:
                want.append(0)
                continue
            e = int(v).bit_length() - 1
            mant = (v >> (e - 2)) & 3 if e >= 2 else (v << (2 - e)) & 3
            want.append(4 * e + int(mant) + 1)
        got = idg_aw_stream.length_class(torch.as_tensor(n))
        assert got.tolist() == want

    @staticmethod
    def _check(starts, ends):
        """A permutation of the table by non-increasing length class, every
        empty entry after every occupied one."""
        order = idg_aw_stream.run_order(starts, ends)
        assert order.dtype == torch.int32 and order.shape == starts.shape
        assert torch.equal(torch.sort(order.long()).values,
                           torch.arange(starts.shape[0]))
        length = (ends - starts)[order.long()]
        cls = idg_aw_stream.length_class(length)
        assert bool((cls[:-1] >= cls[1:]).all())
        occupied = length > 0
        n_occ = int(occupied.sum())
        assert bool(occupied[:n_occ].all()) and not bool(
            occupied[n_occ:].any())


RESIDENT = 264          # an H100's resident gridder blocks at S = 64


def _crowded_lengths(seed, long=60_000, short=500):
    """One tile of ``long`` records among ``short`` runs of 1 to 39, with
    empty entries among them, as the SKA1-Low core crowds a snapshot."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 40, short + 1)
    lengths[rng.random(short + 1) < 0.2] = 0
    lengths[0] = long
    rng.shuffle(lengths)
    return lengths


def _grid64(recs, starts, ends, y0, x0, ia1, ia2, screens, S):
    """The gridding operator in float64, run by run: the padded grid."""
    F = idg_aw_stream._dft_factor64(S, 12.0)
    cq = torch.arange(S, dtype=torch.float64) - S // 2
    k = math.pi * (cq * THETA / S) ** 2
    A = screens.to(torch.complex128)
    a1 = torch.clamp(ia1.long(), 0, A.shape[0] - 1)   # as the kernels clamp
    a2 = torch.clamp(ia2.long(), 0, A.shape[0] - 1)
    out = torch.zeros((N + 2 * S, N + 2 * S), dtype=torch.complex128)
    for i in torch.nonzero(ends > starts).flatten().tolist():
        dy, dx, w, vr, vi = recs[:, int(starts[i]):int(ends[i])].double()
        ey, ex = (torch.polar(torch.ones_like(ph), ph) for ph in (
            2 * math.pi / S * cq * d[:, None] - k * w[:, None]
            for d in (dy, dx)))
        a = (torch.complex(vr, vi)[:, None] * ey).T @ ex
        t = a * torch.conj(A[a1[i]] * A[a2[i]])
        out[int(y0[i]):int(y0[i]) + S, int(x0[i]):int(x0[i]) + S] += (
            F @ t @ F.T)
    return out.numpy()


class TestWorkItems:
    """The kernels' work items (``run_items``): a run of more than L
    records is split into items of L; the items tile every run."""

    @staticmethod
    def _table(lengths):
        ext = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
        return torch.as_tensor(ext[:-1]), torch.as_tensor(ext[1:])

    @pytest.mark.parametrize("S", [32, 64])
    def test_items_tile_the_runs(self, S):
        lengths = _crowded_lengths(3)
        starts, ends = self._table(lengths)
        n = int(lengths.sum())
        L = idg_aw_stream.item_length(n, RESIDENT, S)
        assert L == 32 * S and L % 32 == 0
        run, first, last = idg_aw_stream.run_items(starts, ends, n,
                                                   RESIDENT, S)
        assert bool((last > first).all()) and int((last - first).max()) <= L
        # every record in exactly one item, of its own run
        owner = torch.full((n,), -1, dtype=torch.int64)
        hits = torch.zeros(n, dtype=torch.int64)
        for r, a, b in zip(run.tolist(), first.tolist(), last.tolist()):
            owner[a:b] = r
            hits[a:b] += 1
        assert bool((hits == 1).all())
        want = torch.repeat_interleave(torch.arange(len(lengths)),
                                       torch.as_tensor(lengths))
        assert torch.equal(owner, want)
        # only the long run is split, into ⌈60,000 / L⌉ items
        assert idg_aw_stream.split_counts(run) == (1, -(-60_000 // L))
        per_run = torch.bincount(run.long(), minlength=len(lengths))
        assert torch.equal(per_run[torch.as_tensor(lengths) <= L],
                           (torch.as_tensor(lengths)[
                               torch.as_tensor(lengths) <= L] > 0).long())
        assert idg_aw_stream.extra_items(n, S) >= run.numel() - int(
            (torch.as_tensor(lengths) > 0).sum())

    def test_runs_of_eight_are_never_split(self):
        # IDG-AW's runs: one baseline's 8 dumps in one tile
        lengths = np.full(20_000, 8)
        lengths[::7] = 0
        starts, ends = self._table(lengths)
        run, first, last = idg_aw_stream.run_items(
            starts, ends, int(lengths.sum()), RESIDENT, 64)
        occupied = torch.nonzero(torch.as_tensor(lengths) > 0).flatten()
        assert torch.equal(run.long(), occupied)
        assert torch.equal(first, starts[occupied])
        assert torch.equal(last, ends[occupied])
        assert idg_aw_stream.split_counts(run) == (0, 0)

    def test_item_length_follows_the_even_share(self):
        # above the floor, half a resident block's share in whole chunks
        assert idg_aw_stream.item_length(10**7, RESIDENT, 64) == 18_944
        assert idg_aw_stream.item_length(1_046_528, RESIDENT, 64) == 2048
        assert idg_aw_stream.item_length(5, 1, 2) == 64

    def test_plain_gridder_over_items(self):
        # the items' patches add up to the runs' grid.  The plain runs
        # version sums the 60,000-record tile in one float32 chain, ~4e-6
        # from the operator in float64; the items sum 1,024 at a time and
        # come within 1e-6 of it
        S = 32
        lengths = _crowded_lengths(4)
        recs, starts, ends, y0, x0, ia1, ia2 = (
            torch.as_tensor(x) for x in _hand_table(S, lengths, 4, 4))
        scr = torch.as_tensor(_screens(np.random.default_rng(4), 4, S))
        run, first, last = idg_aw_stream.run_items(
            starts, ends, recs.shape[1], RESIDENT, S)
        assert idg_aw_stream.split_counts(run)[0] == 1
        r = run.long()
        kw = dict(grid_shape=(N, N), theta=THETA, subgrid=S)
        g_runs = idg_aw_stream.grid_from_records_plain(
            recs, starts, ends, y0, x0, ia1, ia2, scr, **kw).numpy()
        g_items = idg_aw_stream.grid_from_records_plain(
            recs, first, last, y0[r], x0[r], ia1[r], ia2[r], scr,
            **kw).numpy()
        g64 = _grid64(recs, starts, ends, y0, x0, ia1, ia2, scr, S)
        assert _rel(g_items, g64) < 1e-6
        assert _rel(g_runs, g64) < 1e-5
        assert _rel(g_items, g_runs) < 1e-5


class TestDispatch:
    @pytest.mark.parametrize("S,support", [(64, 15), (128, 15), (32, 7),
                                           (32, 15), (48, 15)])
    def test_unit_run_bound(self, S, support, jref):
        got = kernels._idg_unit_run_bound((N, N), S, support)
        # the reference adds a 24576-entry cap the port drops; at N=256
        # the two agree wherever the reference takes the run path
        assert got == jref.unit_run_bound((N, N), S, support)

    def test_outside_envelope_raises(self, jref):
        # outside the streamed envelope the fixed-tile route serves the
        # shape, as in the reference; only an unservable support or an odd
        # subgrid still raises
        from ska_sdp_tpu.kernels import idg_gridder as j_idg_gridder

        jnp = jref.jnp
        p, w, _, _, v = random_problem(np.random.default_rng(24), b=1500,
                                       extent=0.52)
        for S, support in ((32, 15), (48, 7)):
            assert kernels._idg_unit_run_bound((N, N), S, support) is None
            got, nd = kernels.idg_gridder(
                (N, N), torch.as_tensor(p), torch.as_tensor(w),
                torch.as_tensor(v), theta=THETA, subgrid=S, support=support)
            want = np.asarray(j_idg_gridder(
                (N, N), jnp.asarray(p), jnp.asarray(w), jnp.asarray(v),
                theta=THETA, subgrid=S, support=support))
            assert int(nd) == 0
            assert _rel(got.numpy(), want) < TOL
        pz = torch.zeros((4, 3))
        wz = torch.zeros((4,))
        vz = torch.ones((4,), dtype=torch.complex64)
        with pytest.raises(ValueError):
            kernels.idg_gridder((N, N), pz, wz, vz, theta=THETA, subgrid=16)
        with pytest.raises(ValueError, match="even"):
            kernels.idg_gridder((N, N), pz, wz, vz, theta=THETA, subgrid=33)

    def test_drop_counters_warn_once(self, capsys):
        kernels.reset_drop_counters()
        kernels.note_drops("idg_gridder", 0, "r")
        assert kernels.drop_counters() == {}
        kernels.note_drops("idg_gridder", 3, "r")
        kernels.note_drops("idg_gridder", 2, "r")
        assert kernels.drop_counters() == {"idg_gridder": 5}
        assert capsys.readouterr().err.count("warning: idg_gridder") == 1
        kernels.reset_drop_counters()


@pytest.mark.cuda
class TestCudaKernel:
    def test_kernel_matches_plain_on_card(self, cuda_device):
        rng = np.random.default_rng(31)
        p, w, a1, a2, vis = track_problem(rng, nant=6, ntime=64)
        scr = _screens(rng, 6)
        recs = idg_aw_run_records(
            (N, N), *(torch.as_tensor(x, device=cuda_device)
                      for x in (p, a1, a2, w, vis.real, vis.imag)),
            max_runs=4096, nant=6)
        scr_t = torch.as_tensor(scr, device=cuda_device)
        idg_aw_stream.reset_launch_count()
        g = idg_aw_stream.idg_aw_grid_from_records_stream(
            *recs[:7], (N, N), scr_t, theta=THETA, subgrid=SA)
        torch.cuda.synchronize()
        assert idg_aw_stream.launch_count() == 1
        plain = idg_aw_stream.grid_from_records_plain(
            *recs[:7], scr_t, grid_shape=(N, N), theta=THETA,
            subgrid=SA)[SA:SA + N, SA:SA + N]
        assert _rel(g.cpu().numpy(), plain.cpu().numpy()) < TOL

    @pytest.mark.parametrize("S", [32, 128])
    def test_kernel_other_subgrids(self, cuda_device, S):
        rng = np.random.default_rng(S)
        p, w, a1, a2, vis = random_problem(rng, 2000, extent=0.4)
        support = 7 if S == 32 else 15
        recs = idg_aw_run_records(
            (N, N), *(torch.as_tensor(x, device=cuda_device)
                      for x in (p, a1, a2, w, vis.real, vis.imag)),
            subgrid=S, support=support, max_runs=4096, nant=1)
        scr = torch.ones((1, S, S), dtype=torch.complex64,
                         device=cuda_device)
        g = idg_aw_stream.idg_aw_grid_from_records_stream(
            *recs[:7], (N, N), scr, theta=THETA, subgrid=S)
        plain = idg_aw_stream.grid_from_records_plain(
            *recs[:7], scr, grid_shape=(N, N), theta=THETA,
            subgrid=S)[S:S + N, S:S + N]
        assert _rel(g.cpu().numpy(), plain.cpu().numpy()) < TOL


def _hand_table(S, lengths, nant, seed, sentinel=0.0, trailing=0):
    """A run table over random records, built by hand for the card tests:
    runs of the given lengths (0: an empty entry) at random origins, random
    pair ids, a share ``sentinel`` of them carrying the prep's sentinel pair
    id (the kernel clamps it), and ``trailing`` empty entries at the end, as
    the prep leaves them.  Returns the first seven gridder arguments."""
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([np.asarray(lengths), np.zeros(trailing, int)])
    n = int(lengths.sum())
    d = S / 2 - 8
    recs = np.stack([rng.uniform(-d, d, n), rng.uniform(-d, d, n),
                     rng.uniform(-250.0, 250.0, n), rng.standard_normal(n),
                     rng.standard_normal(n)]).astype(np.float32)
    ext = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    R = lengths.shape[0]
    hp = N + S
    ia1 = rng.integers(0, nant, R).astype(np.int32)
    ia2 = rng.integers(0, nant, R).astype(np.int32)
    sent = rng.random(R) < sentinel
    ia1[sent] = SENTINEL // PAIR_SHIFT
    ia2[sent] = SENTINEL % PAIR_SHIFT
    return (recs, ext[:-1], ext[1:], rng.integers(0, hp, R).astype(np.int32),
            rng.integers(0, hp, R).astype(np.int32), ia1, ia2)


@pytest.mark.cuda
class TestCudaTensorCoreKernel:
    """The tensor-core gridder against its plain version on the card, at
    every subgrid it takes, on tables the prep rarely makes."""

    @staticmethod
    def _check(dev, table, S, nant, seed):
        t = [torch.as_tensor(x, device=dev) for x in table]
        scr = torch.as_tensor(_screens(np.random.default_rng(seed), nant, S),
                              device=dev)
        idg_aw_stream.reset_launch_count()
        g = idg_aw_stream.idg_aw_grid_from_records_stream(
            *t, (N, N), scr, theta=THETA, subgrid=S)
        torch.cuda.synchronize()
        assert idg_aw_stream.launch_count() == 1
        plain = idg_aw_stream.grid_from_records_plain(
            *t, scr, grid_shape=(N, N), theta=THETA,
            subgrid=S)[S:S + N, S:S + N]
        err = _rel(g.cpu().numpy(), plain.cpu().numpy())
        assert np.isfinite(err) and err < TOL

    # 32, 64, 128: their own instances; the rest on the instance of side
    # 16·⌈S/16⌉, one warp across where that side / 16 is odd
    @pytest.mark.parametrize("S", [32, 64, 128, 16, 20, 48, 80, 96, 112,
                                   126])
    def test_subgrids_random_screens(self, cuda_device, S):
        rng = np.random.default_rng(50 + S)
        lengths = rng.integers(1, 600, 400)
        lengths[rng.random(400) < 0.2] = 0
        self._check(cuda_device, _hand_table(S, lengths, 5, S), S, 5, S)

    def test_long_run_beside_short_ones(self, cuda_device):
        rng = np.random.default_rng(61)
        lengths = np.concatenate([[25000], rng.integers(1, 40, 500)])
        rng.shuffle(lengths)
        self._check(cuda_device, _hand_table(64, lengths, 4, 61), 64, 4, 61)

    def test_kernel_block_order(self, cuda_device):
        # blocks take the runs in the launch's own counting-sort order; on
        # uneven runs with empty entries among them and trailing, parity
        # holds only if that order takes every run exactly once
        rng = np.random.default_rng(63)
        lengths = rng.integers(1, 5000, 3000)
        lengths[rng.random(3000) < 0.3] = 0
        self._check(cuda_device, _hand_table(64, lengths, 2, 63,
                                             trailing=500), 64, 2, 63)

    def test_crowded_tile_is_split(self, cuda_device):
        # one tile of 60,000 records among 500 short runs: its items are
        # gridded apart and added, and counted as the plain items count
        S = 64
        table = _hand_table(S, _crowded_lengths(5), 4, 65)
        t = [torch.as_tensor(x, device=cuda_device) for x in table]
        resident = idg_aw_stream.resident_blocks(idg_aw_stream.GRID_KERNEL,
                                                 S)
        run, _, _ = idg_aw_stream.run_items(t[1], t[2], t[0].shape[1],
                                            resident, S)
        timing.COUNTERS.reset("split/")
        self._check(cuda_device, table, S, 4, 65)
        timing.settle_counts()
        runs, items = idg_aw_stream.split_counts(run)
        assert runs == 1 and items > 1
        assert timing.COUNTERS.group("split/idg_grid/") == {
            "runs": runs, "items": items}

    def test_runs_of_eight_are_not_split(self, cuda_device):
        lengths = np.full(4000, 8)
        lengths[::5] = 0
        timing.COUNTERS.reset("split/")
        self._check(cuda_device, _hand_table(64, lengths, 4, 66), 64, 4, 66)
        timing.settle_counts()
        assert timing.COUNTERS.group("split/idg_grid/") == {
            "runs": 0, "items": 0}

    def test_sentinel_and_empty_entries(self, cuda_device):
        rng = np.random.default_rng(62)
        lengths = rng.integers(1, 300, 600)
        lengths[rng.random(600) < 0.4] = 0
        self._check(cuda_device, _hand_table(64, lengths, 3, 62,
                                             sentinel=0.1, trailing=200),
                    64, 3, 62)
