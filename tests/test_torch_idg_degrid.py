"""Port parity: the streamed IDG(-AW) degridder and its run prep against the
JAX reference (``idg_aw_degrid_records`` and ``idg_aw_degridder_stream``,
the latter run as its own tests run it on the CPU: Pallas interpret mode),
pinned to the ``exact`` precision tier, whose operator (full float32) the
port implements.

Bounds: the prep's integer outputs (``starts_ext``, ``y0``, ``x0``,
``ia1``, ``ia2``, ``order_s``, ``use``, ``n_dropped``) and sorted rows
match exactly; predicted visibilities within rel-L2 5e-5, the reference's
between-route bound; the adjoint identity ``<G, grid(v)> = <degrid(G), v>``
to relative 1e-5, the reference's adjoint bound.

On the CPU the wrapper takes the plain version; the CUDA kernel itself is
checked by the ``cuda``-marked tests, which skip without a card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch import kernels
from ska_sdp_tpu_torch.kernels import idg_aw_stream
from ska_sdp_tpu_torch.kernels.idg_aw_records import (
    from_jax_degrid_records, idg_aw_degrid_records, idg_aw_run_records)

from test_torch_idg_grid import _screens, random_problem, track_problem

torch.set_num_threads(2)

N, THETA, SA = 256, 0.05, 64
UNIT_RUNS = ((N + 2 * SA) // 24 + 2) ** 2 + 64
TOL = 5e-5
ADJ_TOL = 1e-5


@pytest.fixture(scope="module")
def jref():
    """The JAX reference, imported only by the tests that compare with it,
    so the ``cuda`` tests also run where jax is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from ska_sdp_tpu.kernels.idg_aw_degrid_pallas import (
        idg_aw_degrid_records as j_records)
    from ska_sdp_tpu.kernels.idg_aw_pallas import IDG_AW_VMEM_BUDGET
    from ska_sdp_tpu.kernels.idg_aw_stream_pallas import (
        _banded_geometry, _banded_run_prep, idg_aw_degridder_stream)

    return SimpleNamespace(jnp=jnp, records=j_records,
                           degridder=idg_aw_degridder_stream,
                           banded_geometry=_banded_geometry,
                           banded_prep=_banded_run_prep,
                           vmem_budget=IDG_AW_VMEM_BUDGET)


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


def _random_grid(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(*xs, device="cpu"):
    return tuple(torch.as_tensor(x, device=device) for x in xs)


def _prep_case(case):
    """Inputs of one prep case: ``(p, w, a1, a2, max_runs)``."""
    rng = np.random.default_rng(50 + len(case))
    if case == "track":
        p, w, a1, a2, _ = track_problem(rng, nant=5, ntime=40)
        return p, w, a1, a2, 4096
    if case == "random":
        p, w, a1, a2, _ = random_problem(rng, 2500)
        return p, w, a1, a2, UNIT_RUNS
    if case == "oob_unfit":
        p, w, a1, a2, _ = track_problem(rng, nant=5, ntime=40)
        p, a1 = p.copy(), a1.copy()
        p[:40, 0] = 0.7                       # out of bounds: not counted
        p[40:60, 1] = -0.55
        a1[60:70] = 2**15                     # unfit: dropped and counted
        return p, w, a1, a2, 4096
    p, w, a1, a2, _ = track_problem(rng, nant=5, ntime=40)
    return p, w, a1, a2, 6                    # run-table overflow


def _degrid_case(case, rng):
    """``(grid_shape, S, support, p, w, a1, a2, screens, max_runs)``."""
    if case == "unit_random_uv":
        p, w, a1, a2, _ = random_problem(rng, 1200)
        scr = np.ones((1, SA, SA), np.complex64)
        return (N, N), SA, 15, p, w, a1, a2, scr, UNIT_RUNS
    if case == "screens_track":
        p, w, a1, a2, _ = track_problem(rng, nant=5, ntime=40)
        return (N, N), SA, 15, p, w, a1, a2, _screens(rng, 5), 4096
    if case == "screens_track_s32":
        p, w, a1, a2, _ = track_problem(rng, nant=5, ntime=40)
        return (N, N), 32, 9, p, w, a1, a2, _screens(rng, 5, 32), 4096
    # non-square grid: 192 rows (v) by 256 columns (u)
    p, w, a1, a2, _ = track_problem(rng, nant=5, ntime=40)
    p = p.copy()
    p[:, 1] *= 0.7
    return (192, N), SA, 15, p, w, a1, a2, _screens(rng, 5), 4096


def _jax_degrid(jref, shape, S, support, p, w, a1, a2, grid, scr, max_runs):
    jnp = jref.jnp
    v, nd = jref.degridder(
        shape, jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2),
        jnp.asarray(w), jnp.asarray(grid), jnp.asarray(scr), theta=THETA,
        subgrid=S, support=support, max_runs=max_runs, interpret=True)
    return np.asarray(v), int(nd)


class TestDegridPrep:
    @pytest.mark.parametrize("case", ["track", "random", "oob_unfit",
                                      "overflow"])
    def test_matches_reference_exactly(self, case, jref):
        p, w, a1, a2, max_runs = _prep_case(case)
        jnp = jref.jnp
        j = jref.records((N, N), jnp.asarray(p), jnp.asarray(a1),
                         jnp.asarray(a2), jnp.asarray(w), max_runs=max_runs)
        t = idg_aw_degrid_records((N, N), *_t(p, a1, a2, w),
                                  max_runs=max_runs)
        names = ("starts_ext", "y0", "x0", "ia1", "ia2", "order_s", "use",
                 "n_dropped")
        for name, a, b in zip(names, j[1:], t[1:]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=name)
        n = p.shape[0]
        rows = np.asarray(j[0]).transpose(1, 0, 2).reshape(8, -1)[:3, :n]
        np.testing.assert_array_equal(rows, t[0].numpy())
        nd = int(t[8])
        if case == "oob_unfit":
            assert nd == 10
        elif case == "overflow":
            assert nd > 0
        else:
            assert nd == 0

    def test_from_jax_degrid_records(self, jref):
        p, w, a1, a2, max_runs = _prep_case("oob_unfit")
        jnp = jref.jnp
        j = jref.records((N, N), jnp.asarray(p), jnp.asarray(a1),
                         jnp.asarray(a2), jnp.asarray(w), max_runs=max_runs)
        a = from_jax_degrid_records(*[np.asarray(x) for x in j])
        b = idg_aw_degrid_records((N, N), *_t(p, a1, a2, w),
                                  max_runs=max_runs)
        assert a[0].shape == (3, p.shape[0])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
        assert a[6].dtype == torch.int32 and a[7].dtype == torch.bool

    def test_rejects_empty_input(self):
        e = torch.zeros((0, 3))
        z = torch.zeros((0,), dtype=torch.int32)
        with pytest.raises(ValueError):
            idg_aw_degrid_records((N, N), e, z, z, z.float())


class TestPlainDegridderParity:
    @pytest.mark.parametrize("case", ["unit_random_uv", "screens_track",
                                      "screens_track_s32", "non_square"])
    def test_matches_jax_stream(self, case, exact_tier):
        rng = np.random.default_rng(60 + len(case))
        shape, S, support, p, w, a1, a2, scr, mr = _degrid_case(case, rng)
        grid = _random_grid(rng, shape)
        want, nd_want = _jax_degrid(exact_tier, shape, S, support, p, w, a1,
                                    a2, grid, scr, mr)
        idg_aw_stream.reset_launch_count()
        # through the port's own prep
        got, nd_got = idg_aw_stream.idg_aw_degridder_stream(
            shape, *_t(p, a1, a2, w, grid, scr), theta=THETA, subgrid=S,
            support=support, max_runs=mr)
        assert int(nd_got) == nd_want == 0
        assert _rel(got.numpy(), want) < TOL
        # on the reference prep's records: the degridder alone
        jnp = exact_tier.jnp
        j = exact_tier.records(shape, jnp.asarray(p), jnp.asarray(a1),
                               jnp.asarray(a2), jnp.asarray(w), subgrid=S,
                               support=support, max_runs=mr)
        rr = from_jax_degrid_records(*[np.asarray(x) for x in j])
        got2 = idg_aw_stream.idg_aw_degrid_from_records_stream(
            *rr[:7], *_t(grid, scr), theta=THETA, subgrid=S)
        assert _rel(got2.numpy(), want) < TOL
        # a CPU tensor takes the plain version: the kernel never launched
        assert idg_aw_stream.launch_count(idg_aw_stream.DEGRID_KERNEL) == 0

    def test_unplaced_records_predict_exactly_zero(self, exact_tier):
        rng = np.random.default_rng(70)
        p, w, a1, a2, _ = _prep_case("oob_unfit")
        scr = _screens(rng, 5)
        grid = _random_grid(rng, (N, N))
        got, nd = idg_aw_stream.idg_aw_degridder_stream(
            (N, N), *_t(p, a1, a2, w, grid, scr), theta=THETA,
            max_runs=4096)
        got = got.numpy()
        assert int(nd) == 10
        np.testing.assert_array_equal(got[:70], 0)       # oob and unfit
        assert np.all(got[70:] != 0)
        want, nd_want = _jax_degrid(exact_tier, (N, N), SA, 15, p, w, a1,
                                    a2, grid, scr, 4096)
        assert nd_want == 10
        assert _rel(got, want) < TOL
        # overflow: records of runs past a too-small table predict 0
        got_o, nd_o = idg_aw_stream.idg_aw_degridder_stream(
            (N, N), *_t(p, a1, a2, w, grid, scr), theta=THETA, max_runs=6)
        rr = idg_aw_degrid_records((N, N), *_t(p, a1, a2, w), max_runs=6)
        placed = torch.zeros(p.shape[0], dtype=torch.bool)
        placed[rr[6][:int(rr[1][-1])].long()] = True
        placed &= rr[7]
        assert int(nd_o) == 10 + int((rr[7] & ~placed).sum()) > 10
        assert torch.all(got_o[~placed] == 0)
        assert torch.all(got_o[placed] != 0)


class TestAdjoint:
    @pytest.mark.parametrize("shape,S,support", [((N, N), 64, 15),
                                                 ((N, N), 32, 9),
                                                 ((192, N), 64, 15)])
    def test_dot_product_identity(self, shape, S, support):
        rng = np.random.default_rng(80 + S + shape[0])
        p, w, a1, a2, vis = track_problem(rng, nant=5, ntime=40)
        p = p.copy()
        p[:, 1] *= shape[0] / N
        scr = _screens(rng, 5, S)
        G = _random_grid(rng, shape)
        g, nd_g = idg_aw_stream.idg_aw_gridder_stream(
            shape, *_t(p, a1, a2, w, vis, scr), theta=THETA, subgrid=S,
            support=support, max_runs=4096)
        d, nd_d = idg_aw_stream.idg_aw_degridder_stream(
            shape, *_t(p, a1, a2, w, G, scr), theta=THETA, subgrid=S,
            support=support, max_runs=4096)
        assert int(nd_g) == int(nd_d) == 0
        lhs = np.vdot(G.astype(np.complex128), g.numpy().astype(np.complex128))
        rhs = np.vdot(d.numpy().astype(np.complex128),
                      vis.astype(np.complex128))
        assert abs(lhs - rhs) <= ADJ_TOL * abs(lhs)


class TestDegridPieces:
    def test_kernel_input_checks(self):
        S = SA
        n = 10
        recs = torch.zeros((3, n))
        runs = tuple(torch.zeros((4,), dtype=torch.int32) for _ in range(6))
        order = torch.arange(n, dtype=torch.int32)
        scr = torch.ones((1, S, S), dtype=torch.complex64)
        gp = torch.zeros((N + 2 * S, N + 2 * S), dtype=torch.complex64)
        kw = dict(theta=THETA, subgrid=S, taper_beta=12.0)
        idg_aw_stream._check_cuda_inputs(recs, runs, scr, S, rows=3)
        with pytest.raises(ValueError):      # gridder rows
            idg_aw_stream._check_cuda_inputs(recs, runs, scr, S)
        with pytest.raises(ValueError):
            idg_aw_stream._degrid_from_records_cuda(
                recs, *runs, order.long(), scr, grid=gp, **kw)
        with pytest.raises(ValueError):
            idg_aw_stream._degrid_from_records_cuda(
                recs, *runs, order[:5], scr, grid=gp, **kw)
        with pytest.raises(ValueError):
            idg_aw_stream._degrid_from_records_cuda(
                recs, *runs, order, scr, grid=gp.to(torch.complex128), **kw)
        with pytest.raises(ValueError):
            idg_aw_stream._degrid_from_records_cuda(
                recs, *runs, order, scr, grid=gp, theta=THETA, subgrid=48,
                taper_beta=12.0)

    def test_dispatch_envelopes(self):
        p = torch.zeros((4, 3))
        w = torch.zeros((4,))
        z = torch.zeros((4,), dtype=torch.int32)
        g = torch.zeros((N, N), dtype=torch.complex64)
        v = torch.ones((4,), dtype=torch.complex64)
        with pytest.raises(NotImplementedError, match="idg_degrid_pallas"):
            kernels.idg_degridder((N, N), p, w, g, theta=THETA, subgrid=32)
        with pytest.raises(ValueError):
            kernels.idg_degridder((N, N), p, w, g, theta=THETA, subgrid=16)
        scr = torch.ones((1, 48, 48), dtype=torch.complex64)
        with pytest.raises(NotImplementedError, match="idg_aw"):
            kernels.idg_aw_gridder((N, N), p, z, z, w, v, scr, theta=THETA,
                                   subgrid=48)
        with pytest.raises(NotImplementedError, match="idg_aw"):
            kernels.idg_aw_degridder((N, N), p, z, z, w, g, scr,
                                     theta=THETA, subgrid=48)
        with pytest.raises(ValueError, match="grid_shape"):
            kernels.idg_aw_degridder((N, 128), p, z, z, w, g, scr[:, :32,
                                                                  :32],
                                     theta=THETA, subgrid=32, support=9)


class TestBandFold:
    """The reference's banded kernels (#3, #4) split a grid too large for
    VMEM into row bands; the port's grid lives in device memory, so both
    fold into the streamed kernels.  At 4800² the port's gridder and
    degridder preps must drop exactly what the banded prep drops."""

    @pytest.mark.parametrize("direction", ["grid", "degrid"])
    def test_4800_drops_match_banded_prep(self, direction, jref):
        theta, lam = 0.016, 300000
        n_lg = int(round(theta * lam))
        rng = np.random.default_rng(90)
        p, w, a1, a2, vis = track_problem(rng, nant=16, ntime=24, nchan=1)
        p, a1 = p.copy(), a1.copy()
        p[:60, 0] = 0.52                      # out of bounds
        p[60:90, 1] = -0.5 + 2.0 / n_lg       # on the lower grid edge
        a1[90:100] = 2**15 + 3                # unfit: counted
        _, _, K, Hb, _ = jref.banded_geometry(n_lg, n_lg, 64,
                                              jref.vmem_budget)
        assert K > 1
        mr = 65536
        jnp = jref.jnp
        out = jref.banded_prep(
            (n_lg, n_lg), jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2),
            [jnp.asarray(w)], n_bands=K, band_rows_hb=Hb, subgrid=64,
            chunk=256, support=15, max_runs=mr, fit_margin=0)
        nd_band = int(out[9])
        if direction == "grid":
            nd = idg_aw_run_records((n_lg, n_lg), *_t(p, a1, a2, w, vis.real,
                                                       vis.imag),
                                    max_runs=mr, nant=16)[7]
        else:
            nd = idg_aw_degrid_records((n_lg, n_lg), *_t(p, a1, a2, w),
                                       max_runs=mr)[8]
        assert int(nd) == nd_band == 10         # the 10 unfit records


@pytest.mark.cuda
class TestCudaKernel:
    @pytest.mark.parametrize("S,support", [(32, 9), (64, 15), (128, 15)])
    def test_kernel_matches_plain_on_card(self, cuda_device, S, support):
        rng = np.random.default_rng(100 + S)
        p, w, a1, a2, _ = track_problem(rng, nant=6, ntime=64)
        p, a1 = p.copy(), a1.copy()
        p[:20, 0] = 0.7                       # sentinel runs predict 0
        a1[20:25] = 2**15
        scr = torch.as_tensor(_screens(rng, 6, S), device=cuda_device)
        grid = torch.as_tensor(_random_grid(rng, (N, N)), device=cuda_device)
        recs = idg_aw_degrid_records((N, N), *_t(p, a1, a2, w,
                                                 device=cuda_device),
                                     subgrid=S, support=support,
                                     max_runs=4096)
        idg_aw_stream.reset_launch_count()
        got = idg_aw_stream.idg_aw_degrid_from_records_stream(
            *recs[:7], grid, scr, theta=THETA, subgrid=S)
        torch.cuda.synchronize()
        assert idg_aw_stream.launch_count(idg_aw_stream.DEGRID_KERNEL) == 1
        plain = idg_aw_stream.degrid_from_records_plain(
            *recs[:7], grid, scr, theta=THETA, subgrid=S)
        got, plain = got.cpu().numpy(), plain.cpu().numpy()
        assert _rel(got, plain) < TOL
        np.testing.assert_array_equal(got[:25], 0)

    def test_adjoint_on_card(self, cuda_device):
        rng = np.random.default_rng(111)
        p, w, a1, a2, vis = track_problem(rng, nant=6, ntime=64)
        scr = _screens(rng, 6)
        G = _random_grid(rng, (N, N))
        g, _ = idg_aw_stream.idg_aw_gridder_stream(
            (N, N), *_t(p, a1, a2, w, vis, scr, device=cuda_device),
            theta=THETA, max_runs=4096)
        d, _ = idg_aw_stream.idg_aw_degridder_stream(
            (N, N), *_t(p, a1, a2, w, G, scr, device=cuda_device),
            theta=THETA, max_runs=4096)
        lhs = np.vdot(G.astype(np.complex128),
                      g.cpu().numpy().astype(np.complex128))
        rhs = np.vdot(d.cpu().numpy().astype(np.complex128),
                      vis.astype(np.complex128))
        assert abs(lhs - rhs) <= ADJ_TOL * abs(lhs)
