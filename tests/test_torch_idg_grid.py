"""Port parity: the streamed IDG(-AW) gridder against the JAX reference's
``idg_aw_gridder_stream`` run as its own tests run it on the CPU (Pallas
interpret mode), pinned to the ``exact`` precision tier — the tier whose
operator (full float32) the port implements.

Bound: grid rel-L2 ≤ 5e-5 with equal ``n_dropped`` — the bound the
reference's own tests allow between two routes to this operator.  The
port is checked both on the reference prep's records
(``from_jax_run_records``: kernel parity alone) and through its own prep.

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
    from_jax_run_records, idg_aw_run_records)
from ska_sdp_tpu_torch.ops.idg_aw import aw_screens_host

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
        kernels._note_drops("idg_gridder", 0, "r")
        assert kernels.drop_counters() == {}
        kernels._note_drops("idg_gridder", 3, "r")
        kernels._note_drops("idg_gridder", 2, "r")
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
