"""Port parity: IDG-AW at subgrids other than 32, 64 and 128.

The reference serves those subgrids with its XLA realization
(``ska_sdp_tpu/ops/idg_aw.py::idg_grid_aw`` / ``idg_degrid_aw``), which
groups records into the same (pair, uv-tile) runs as the streamed prep.
The port has no second route: ``kernels.idg_aw_gridder`` /
``idg_aw_degridder`` run the streamed prep and kernels at every even S up
to 128 whose taper fit margin is positive.  Here the same numpy inputs,
made from a seed, go through both on the CPU (x64 as the reference's own
tests run it; the port's wrappers take their plain versions).

Bounds: grid and visibility rel-L2 ≤ 5e-5 (the reference's between-route
bound) with identical ``n_dropped``, including a run table small enough to
overflow and a forced small fit margin that leaves records unfit; the
adjoint identity at every even S from 28 to 128 to 1e-5 (float32 sums);
the cube entry and the CLI at S=48 within 1e-4 over the central 75% of
the JAX entries.  The ``cuda``-marked tests hold the CUDA kernels to their
plain versions at S=40 (the SP=48 padded instance) and S=48 (an odd
multiple of 16) and skip without a card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch import cli, kernels
from ska_sdp_tpu_torch.config import GridParams, ImagingConfig
from ska_sdp_tpu_torch.io import h5, schema
from ska_sdp_tpu_torch.io.synthetic import SyntheticConfig, generate_dataset
from ska_sdp_tpu_torch.kernels import idg_aw_stream
from ska_sdp_tpu_torch.kernels.idg_aw_records import (idg_aw_degrid_records,
                                                      idg_aw_run_records)
from ska_sdp_tpu_torch.models import spectral
from ska_sdp_tpu_torch.ops.idg_aw import aw_screens_host, auto_fit_margin
from ska_sdp_tpu_torch.utils.timing import PhaseTimer
from test_torch_idg_grid import track_problem

torch.set_num_threads(2)

N, THETA = 256, 0.05
TOL = 5e-5
ADJ_TOL = 1e-5
IMG_TOL = 1e-4


@pytest.fixture(scope="module")
def j():
    """The JAX reference, imported only by the tests that compare with it,
    so the ``cuda`` tests also run where jax is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from ska_sdp_tpu import cli as j_cli
    from ska_sdp_tpu.models import spectral as j_spectral
    from ska_sdp_tpu.ops.idg_aw import idg_degrid_aw, idg_grid_aw
    from ska_sdp_tpu.utils.timing import PhaseTimer as JPhaseTimer

    return SimpleNamespace(jnp=jnp, grid=idg_grid_aw, degrid=idg_degrid_aw,
                           cli=j_cli, spectral=j_spectral,
                           PhaseTimer=JPhaseTimer)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _crop(a):
    n = a.shape[-1]
    return a[..., n // 8:n - n // 8, n // 8:n - n // 8]


def _screens(rng, nant, S):
    ak = np.zeros((nant, 5, 5), np.complex128)
    ak[:, 2, 2] = 1.0
    ak += 0.05 * (rng.standard_normal((nant, 5, 5))
                  + 1j * rng.standard_normal((nant, 5, 5)))
    return aw_screens_host(ak, S).astype(np.complex64)


def _problem(seed, S, nant=5, ntime=32):
    rng = np.random.default_rng(seed)
    p, w, a1, a2, vis = track_problem(rng, nant=nant, ntime=ntime, nchan=2)
    scr = _screens(rng, nant, S)
    grid = (rng.standard_normal((N, N))
            + 1j * rng.standard_normal((N, N))).astype(np.complex64)
    return SimpleNamespace(p=p, w=w, a1=a1, a2=a2, vis=vis, scr=scr,
                           grid=grid)


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(np.asarray(a), device=device) for a in arrays]


# (S, max_runs, fit_margin): the auto margin with room to spare, a run
# table small enough to overflow, and a forced margin that leaves records
# unfit
CASES = [(40, 4096, 0), (48, 4096, 0), (96, 4096, 0), (48, 6, 0),
         (48, 4096, 3), (96, 12, 0)]


class TestAgainstXlaRoute:
    @pytest.mark.parametrize("S, max_runs, fit_margin", CASES)
    def test_gridder(self, j, S, max_runs, fit_margin):
        pr = _problem(40 + S, S)
        kw = dict(theta=THETA, subgrid=S, max_runs=max_runs,
                  fit_margin=fit_margin)
        jnp = j.jnp
        want, nd_want = j.grid((N, N), *(jnp.asarray(x) for x in (
            pr.p, pr.a1, pr.a2, pr.w, pr.vis, pr.scr)), **kw)
        got, nd_got = kernels.idg_aw_gridder((N, N), *_t(
            pr.p, pr.a1, pr.a2, pr.w, pr.vis, pr.scr), **kw)
        assert int(nd_got) == int(nd_want)
        if max_runs < 100 or fit_margin:
            assert int(nd_got) > 0
        else:
            assert int(nd_got) == 0
        assert _rel(got.numpy(), np.asarray(want)) < TOL

    @pytest.mark.parametrize("S, max_runs, fit_margin", CASES)
    def test_degridder(self, j, S, max_runs, fit_margin):
        pr = _problem(60 + S, S)
        kw = dict(theta=THETA, subgrid=S, max_runs=max_runs,
                  fit_margin=fit_margin)
        jnp = j.jnp
        want, nd_want = j.degrid((N, N), *(jnp.asarray(x) for x in (
            pr.p, pr.a1, pr.a2, pr.w, pr.grid, pr.scr)), **kw)
        got, nd_got = kernels.idg_aw_degridder((N, N), *_t(
            pr.p, pr.a1, pr.a2, pr.w, pr.grid, pr.scr), **kw)
        want = np.asarray(want)
        assert int(nd_got) == int(nd_want)
        assert _rel(got.numpy(), want) < TOL
        # dropped records predict 0 on both routes
        np.testing.assert_array_equal(got.numpy() == 0, want == 0)


class TestEnvelope:
    @pytest.mark.parametrize("S", list(range(28, 129, 2)))
    def test_every_even_subgrid_is_an_adjoint_pair(self, S):
        pr = _problem(S, S, nant=4, ntime=12)
        p, a1, a2, w, vis, scr, grid = _t(pr.p, pr.a1, pr.a2, pr.w, pr.vis,
                                          pr.scr, pr.grid)
        kw = dict(theta=THETA, subgrid=S, max_runs=4096)
        g, nd_g = kernels.idg_aw_gridder((N, N), p, a1, a2, w, vis, scr,
                                         **kw)
        v, nd_d = kernels.idg_aw_degridder((N, N), p, a1, a2, w, grid, scr,
                                           **kw)
        assert auto_fit_margin(S, 15) > 0
        assert int(nd_g) == int(nd_d)
        lhs = np.vdot(pr.grid.astype(np.complex128),
                      g.numpy().astype(np.complex128))
        rhs = np.vdot(v.numpy().astype(np.complex128),
                      pr.vis.astype(np.complex128))
        assert abs(lhs - rhs) / abs(lhs) < ADJ_TOL

    @pytest.mark.parametrize("S, match", [(26, "subgrid too small"),
                                          (47, "even subgrid"),
                                          (130, "even subgrid"),
                                          (0, "even subgrid")])
    def test_refused_subgrids(self, S, match):
        pr = _problem(1, 32, nant=3, ntime=4)
        p, a1, a2, w, vis, grid = _t(pr.p, pr.a1, pr.a2, pr.w, pr.vis,
                                     pr.grid)
        scr = torch.ones((3, max(S, 1), max(S, 1)), dtype=torch.complex64)
        with pytest.raises(ValueError, match=match):
            kernels.idg_aw_gridder((N, N), p, a1, a2, w, vis, scr,
                                   theta=THETA, subgrid=S)
        with pytest.raises(ValueError, match=match):
            kernels.idg_aw_degridder((N, N), p, a1, a2, w, grid, scr,
                                     theta=THETA, subgrid=S)


CFG = SyntheticConfig(
    theta=0.05, lam=3600, nant=6, ntime=48, nsources=3, nw_planes=4,
    qpx=4, npix_ff=128, npix_kern=15, seed=11, nchan=4, chan_bw=2.0e6,
)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    paths, _ = generate_dataset(str(tmp_path_factory.mktemp("aw48")), CFG)
    return paths


class TestEntriesAtS48:
    def test_cube_matches_jax_entry(self, j, data, tmp_path):
        from ska_sdp_tpu.config import GridParams as JGridParams
        from ska_sdp_tpu.config import ImagingConfig as JImagingConfig

        grid = dict(theta=CFG.theta, lam=CFG.lam)
        out = {}
        for side, fn, conf, timer, extra in (
                ("t", spectral.aw_idg_gridding_multi,
                 ImagingConfig(grid=GridParams(**grid)), PhaseTimer(),
                 dict(device="cpu")),
                ("j", j.spectral.aw_idg_gridding_multi,
                 JImagingConfig(grid=JGridParams(**grid)), j.PhaseTimer(),
                 {})):
            _, _, cube = fn(data["akern"], data["vis"], CFG.nchan,
                            outfile=str(tmp_path / f"{side}.h5"),
                            config=conf, timer=timer, subgrid=48, **extra)
            out[side] = (cube, timer.counters.get("multichannel/dropped",
                                                  0.0))
        (t, nd_t), (jj, nd_j) = out["t"], out["j"]
        n = int(round(CFG.theta * CFG.lam))
        assert t.shape == jj.shape == (CFG.nchan, n, n)
        assert nd_t == nd_j == 0
        for c in range(CFG.nchan):
            assert _rel(_crop(t[c]), _crop(jj[c])) < IMG_TOL, c

    @pytest.mark.parametrize("extra", [[], ["--channels", "4"]])
    def test_cli_matches_jax_cli(self, j, data, tmp_path, extra):
        import os

        d = os.path.dirname(data["vis"])
        geo = ["--theta", str(CFG.theta), "--lam", str(CFG.lam)]
        argv = ["--mode", "aw", "--idg", "--subgrid", "48", "-i", d, "--all",
                *extra, *geo]
        out_t, out_j = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
        assert cli.main([*argv, "-o", out_t, "--device", "cpu"]) == 0
        assert j.cli.main([*argv, "-o", out_j, "--backend", "cpu"]) == 0
        got = h5.read_dataset(out_t, schema.IMG_DATASET)
        want = h5.read_dataset(out_j, schema.IMG_DATASET)
        assert got.shape == want.shape
        assert _rel(_crop(got), _crop(want)) < IMG_TOL


class TestCudaKernels:
    @pytest.mark.cuda
    @pytest.mark.parametrize("S", [40, 48])
    def test_kernels_match_plain(self, cuda_device, S):
        pr = _problem(80 + S, S, nant=6, ntime=64)
        dev = cuda_device
        p, a1, a2, w, vis, scr, grid = _t(pr.p, pr.a1, pr.a2, pr.w, pr.vis,
                                          pr.scr, pr.grid, device=dev)
        kw = dict(theta=THETA, subgrid=S, taper_beta=12.0)
        recs = idg_aw_run_records((N, N), p, a1, a2, w, vis.real, vis.imag,
                                  subgrid=S, max_runs=4096, nant=6)
        idg_aw_stream.reset_launch_count()
        k = idg_aw_stream.idg_aw_grid_from_records_stream(
            *recs[:7], (N, N), scr, **kw)
        pl = idg_aw_stream.grid_from_records_plain(
            *recs[:7], scr, grid_shape=(N, N), **kw)[S:S + N, S:S + N]
        assert _rel(k.cpu().numpy(), pl.cpu().numpy()) < TOL
        drecs = idg_aw_degrid_records((N, N), p, a1, a2, w, subgrid=S,
                                      max_runs=4096)
        kd = idg_aw_stream.idg_aw_degrid_from_records_stream(
            *drecs[:7], grid, scr, **kw)
        pd = idg_aw_stream.degrid_from_records_plain(*drecs[:7], grid, scr,
                                                     **kw)
        assert _rel(kd.cpu().numpy(), pd.cpu().numpy()) < TOL
        assert idg_aw_stream.launch_count(idg_aw_stream.GRID_KERNEL) == 1
        assert idg_aw_stream.launch_count(idg_aw_stream.DEGRID_KERNEL) == 1
