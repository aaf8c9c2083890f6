"""Port parity: the fixed-tile IDG gridder and degridder, their prep and the
stage-timed IDG pipeline against the JAX reference (``idg_pallas`` and
``idg_degrid_pallas`` run as their own tests run them on the CPU: Pallas
interpret mode; and the XLA oracle ``ops.idg.idg_grid_wproj``).  The port
runs the fixed-tile records on the streamed kernels: ``TestTileRuns`` holds
its run table exactly to the prep's ``starts`` and the origin formula.

Bounds: the prep's ``starts`` and ``valid`` match exactly and its rows
within 1e-6, compared per subgrid in a canonical order (the reference's
sort is not stable); grids and visibilities within rel-L2 5e-5, the
reference's between-route bound, with out-of-bounds records predicting
exactly 0; the adjoint identity ``<G, grid(v)> = <degrid(G), v>`` to
relative 1e-5; images within 1e-4 over the central 75%, the image contract
(the taper division amplifies any difference toward the edge).

On the CPU the wrappers take the streamed kernels' plain versions; the
CUDA kernels themselves are checked by the ``cuda``-marked tests, which
skip without a card.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
from ska_sdp_tpu_torch.kernels import idg_tile
from ska_sdp_tpu_torch.utils.timing import PhaseTimer
from torch_jax_records import from_jax_tile_records

torch.set_num_threads(2)

N, THETA, LAM = 256, 0.05, 5120
SHAPES = [(N, N), (N, 192)]
CASES = [(16, 7), (32, 15), (48, 15), (64, 15)]
TOL = 5e-5
ADJ_TOL = 1e-5
IMG_TOL = 1e-4


@pytest.fixture(scope="module")
def jref():
    """The JAX reference, imported only by the tests that compare with it,
    so the ``cuda`` tests also run where jax is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from ska_sdp_tpu.kernels.idg_degrid_pallas import (
        _prep_with_order, idg_degrid_wproj_pallas)
    from ska_sdp_tpu.kernels.idg_pallas import (
        idg_bin_records, idg_bin_records_multi, idg_grid_from_records,
        idg_gridder_pallas, idg_records_for_channel)
    from ska_sdp_tpu.ops.idg import idg_grid_wproj

    return SimpleNamespace(jnp=jnp, bin_records=idg_bin_records,
                           bin_records_multi=idg_bin_records_multi,
                           records_for_channel=idg_records_for_channel,
                           prep_with_order=_prep_with_order,
                           grid_from_records=idg_grid_from_records,
                           gridder=idg_gridder_pallas,
                           degridder=idg_degrid_wproj_pallas,
                           grid_wproj=idg_grid_wproj)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _crop(a):
    n = a.shape[0]
    return a[n // 8:n - n // 8, n // 8:n - n // 8]


def random_problem(seed, b=2000, extent=0.53, shape=(N, N)):
    """Records uniform over a box a little beyond the grid's edges (some
    anchors lie off the grid), random w and visibilities, and a random
    model grid."""
    rng = np.random.default_rng(seed)
    p = np.zeros((b, 3), np.float32)
    p[:, :2] = rng.uniform(-extent, extent, (b, 2))
    w = rng.uniform(-250.0, 250.0, b).astype(np.float32)
    vis = (rng.standard_normal(b) + 1j * rng.standard_normal(b)
           ).astype(np.complex64)
    grid = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)
    return p, w, vis, grid


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _jax_geometry(shape, S):
    T = S // 2
    return (shape[0], shape[1], S, T, T, -(-(shape[0] + 2 * T) // T) + 1,
            -(-(shape[1] + 2 * T) // T) + 1)


def _canonical(rows, starts):
    """Rows ``[k, m]`` of the first ``starts[-1]`` records, sorted within
    each subgrid lexicographically (an order both sorts agree on)."""
    m = int(starts[-1])
    seg = np.repeat(np.arange(starts.shape[0] - 1), np.diff(starts))
    r = rows[:, :m]
    order = np.lexsort(tuple(r[::-1]) + (seg,))
    return r[:, order]


class TestPrep:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("S,support", CASES)
    def test_bin_records(self, jref, S, support, shape):
        p, w, vis, _ = random_problem(30 + S, shape=shape)
        jnp = jref.jnp
        recs_j, starts_j = jref.bin_records(
            shape, jnp.asarray(p), jnp.asarray(w), jnp.asarray(vis.real),
            jnp.asarray(vis.imag), subgrid=S, support=support)
        recs, starts = idg_tile.idg_bin_records(
            shape, *_t(p, w, vis.real, vis.imag), subgrid=S,
            support=support)
        starts_j = np.asarray(starts_j)
        np.testing.assert_array_equal(starts.numpy(), starts_j)
        assert 0 < starts_j[-1] < p.shape[0]     # some records excluded
        rows_j, _ = from_jax_tile_records(recs_j, starts_j)
        np.testing.assert_allclose(
            _canonical(recs.numpy(), starts_j),
            _canonical(rows_j.numpy(), starts_j), rtol=1e-6, atol=1e-6)
        # excluded records carry zero visibilities
        assert not recs[3:, int(starts_j[-1]):].any()

    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("S,support", CASES)
    def test_prep_with_order(self, jref, S, support, shape):
        p, w, _, _ = random_problem(40 + S, shape=shape)
        jnp = jref.jnp
        out_j = jref.prep_with_order(*_jax_geometry(shape, S),
                                     jnp.asarray(p), jnp.asarray(w),
                                     support)
        recs_j, starts_j, order_j, valid_j = from_jax_tile_records(
            *[np.asarray(x) for x in out_j])
        recs, starts, order, valid = idg_tile.prep_with_order(
            shape, *_t(p, w), subgrid=S, support=support)
        np.testing.assert_array_equal(starts.numpy(), starts_j.numpy())
        np.testing.assert_array_equal(valid.numpy(), valid_j.numpy())
        # the same records in each subgrid, each with the same geometry
        st = starts.numpy()
        m = int(st[-1])
        seg = np.repeat(np.arange(st.shape[0] - 1), np.diff(st))
        od, od_j = order.numpy()[:m], order_j.numpy()[:m]
        np.testing.assert_array_equal(od[np.lexsort((od, seg))],
                                      od_j[np.lexsort((od_j, seg))])
        by_index = np.zeros((3, p.shape[0]), np.float32)
        by_index_j = np.zeros_like(by_index)
        by_index[:, order.numpy()[:m]] = recs.numpy()[:, :m]
        by_index_j[:, order_j.numpy()[:m]] = recs_j.numpy()[:, :m]
        np.testing.assert_allclose(by_index, by_index_j, rtol=1e-6,
                                   atol=1e-6)

    def test_odd_and_oversize_subgrids(self):
        p = torch.zeros((4, 3))
        w = torch.zeros((4,))
        v = torch.ones((4,))
        with pytest.raises(ValueError, match="even"):
            idg_tile.idg_bin_records((N, N), p, w, v, v, subgrid=31,
                                     support=7)
        with pytest.raises(NotImplementedError):
            idg_tile.idg_bin_records((N, N), p, w, v, v, subgrid=130,
                                     support=15)
        with pytest.raises(ValueError, match="support"):
            idg_tile.prep_with_order((N, N), p, w, subgrid=16, support=15)


def _edge_problem(shape, S, support, seed, b=600):
    """Random records with support anchors pinned to the grid's first and
    last rows and columns (``y0 = −s + 1`` and ``y0 = N − 1``), where the
    subgrids' origins reach their extremes, and two channels of random
    visibilities."""
    N, Nx = shape
    s = support
    rng = np.random.default_rng(seed)
    p = np.zeros((b, 3), np.float32)
    p[:, :2] = rng.uniform(-0.52, 0.52, (b, 2))
    p[:20, 1] = (N - 1 + s // 2 - N // 2) / N
    p[20:40, 0] = (Nx - 1 + s // 2 - Nx // 2) / Nx
    p[40:60, 1] = (1 - s + s // 2 - N // 2) / N
    p[60:80, 0] = (1 - s + s // 2 - Nx // 2) / Nx
    w = rng.uniform(-250.0, 250.0, b).astype(np.float32)
    vis = (rng.standard_normal((2, b))
           + 1j * rng.standard_normal((2, b))).astype(np.complex64)
    return p, w, vis


class TestTileRuns:
    """The fixed-tile records as the streamed kernels' run table."""

    @staticmethod
    def _check(r, starts, shape, S):
        """Run t is subgrid t: its records ``[starts[t], starts[t + 1])``,
        its origin ``(gy·T + T, gx·T + T)`` and pair 0; returns the occupied
        subgrids' origins, which must lie inside ``[0, N + S] × [0, Nx +
        S]``."""
        st = starts.numpy()
        geo = idg_tile.tile_geometry(shape, S)
        assert all(x.dtype == torch.int32 for x in r)
        np.testing.assert_array_equal(r.starts_ext.numpy(), st)
        t = np.arange(geo.n_sub)
        np.testing.assert_array_equal(r.y0.numpy(),
                                      (t // geo.ntx) * geo.T + geo.T)
        np.testing.assert_array_equal(r.x0.numpy(),
                                      (t % geo.ntx) * geo.T + geo.T)
        assert r.pair.shape == (geo.n_sub,) and not r.pair.numpy().any()
        occ = np.nonzero(st[1:] > st[:-1])[0]
        y0, x0 = r.y0.numpy()[occ], r.x0.numpy()[occ]
        N, Nx = shape
        assert 0 <= y0.min() and y0.max() <= N + S
        assert 0 <= x0.min() and x0.max() <= Nx + S
        return y0, x0

    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("S,support", CASES)
    def test_single_channel_preps(self, S, support, shape):
        p, w, vis, _ = random_problem(130 + S, shape=shape)
        pt, wt, vt = _t(p, w, vis)
        _, starts = idg_tile.idg_bin_records(
            shape, pt, wt, vt.real, vt.imag, subgrid=S, support=support)
        self._check(idg_tile.tile_runs(starts, shape, S), starts, shape, S)
        _, dstarts, _, _ = idg_tile.prep_with_order(
            shape, pt, wt, subgrid=S, support=support)
        self._check(idg_tile.tile_runs(dstarts, shape, S), dstarts, shape,
                    S)

    @pytest.mark.parametrize("S,support,shape,c0", [
        (20, 11, (250, 230), -1),     # c0 = -1, the origins' bound tight
        (32, 15, (256, 256), 0),
        (32, 15, (250, 230), 0)])
    def test_multi_prep_centred_window(self, jref, S, support, shape, c0):
        # the multi prep clamps its centred stride cell: with c0 = −1 an
        # anchor on the last row sits in the subgrid whose origin is N + S,
        # the last one whose patch still fits the S-padded grid
        assert (S - support) // 2 - (S // 2) // 2 == c0
        p, w, vis = _edge_problem(shape, S, support, 140 + S)
        pt, wt, vt = _t(p, w, vis)
        base, vis_s, starts = idg_tile.idg_bin_records_multi(
            shape, pt, wt, vt.real, vt.imag, subgrid=S, support=support)
        y0, x0 = self._check(idg_tile.tile_runs(starts, shape, S), starts,
                             shape, S)
        N, Nx = shape
        if c0 < 0 and N % (S // 2) == 0 and Nx % (S // 2) == 0:
            assert y0.max() == N + S and x0.max() == Nx + S
        # and the route grids each channel as the reference does
        jnp = jref.jnp
        base_j, vis_j, st_j = jref.bin_records_multi(
            shape, jnp.asarray(p), jnp.asarray(w), jnp.asarray(vis.real),
            jnp.asarray(vis.imag), subgrid=S, support=support)
        np.testing.assert_array_equal(starts.numpy(), np.asarray(st_j))
        for c, ratio in enumerate((1.0, 1.0)):
            recs_j, nm_j = jref.records_for_channel(
                base_j, vis_j[c], ratio, subgrid=S, support=support)
            gr, gi = jref.grid_from_records(recs_j, st_j, shape, theta=THETA,
                                            subgrid=S, interpret=True)
            want = np.asarray(gr) + 1j * np.asarray(gi)
            recs, nm = idg_tile.idg_records_for_channel(
                base, vis_s[c], ratio, subgrid=S, support=support)
            got = idg_tile.idg_grid_from_records(recs, starts, shape,
                                                 theta=THETA, subgrid=S)
            assert int(nm) == int(nm_j)
            assert _rel(got.numpy(), want) < TOL

    def test_raises_on_out_of_range_origin(self):
        shape, S = (N, 192), 32
        geo = idg_tile.tile_geometry(shape, S)
        p, w, vis, _ = random_problem(150, shape=shape)
        pt, wt, vt = _t(p, w, vis)
        recs, starts = idg_tile.idg_bin_records(
            shape, pt, wt, vt.real, vt.imag, subgrid=S)
        idg_tile.tile_runs(starts, shape, S)          # the prep's: fine
        # one record in the last row's last subgrid, origin (nty·T, ntx·T),
        # or in the first row's last one, origin (T, ntx·T): both lie past
        # the S-padded grid's last origin, and the patch would leave it
        for t in (geo.n_sub - 1, geo.ntx - 1):
            bad = torch.zeros_like(starts)
            bad[t + 1:] = 1
            with pytest.raises(ValueError, match="origin"):
                idg_tile.tile_runs(bad, shape, S)
            with pytest.raises(ValueError, match="origin"):
                idg_tile.idg_grid_from_records(recs[:, :1], bad, shape,
                                               theta=THETA, subgrid=S)
        with pytest.raises(ValueError, match="starts"):
            idg_tile.tile_runs(starts[:-1], shape, S)


class TestGridder:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("S,support", CASES)
    def test_matches_pallas_and_xla(self, jref, S, support, shape):
        p, w, vis, _ = random_problem(50 + S, shape=shape)
        jnp = jref.jnp
        args = (shape, jnp.asarray(p), jnp.asarray(w), jnp.asarray(vis))
        kw = dict(theta=THETA, subgrid=S, support=support)
        want = np.asarray(jref.gridder(*args, **kw, interpret=True))
        want_xla = np.asarray(jref.grid_wproj(*args, **kw))
        idg_tile.reset_launch_count()
        got = idg_tile.idg_gridder_tile(shape, *_t(p, w, vis), **kw)
        assert got.dtype == torch.complex64
        assert tuple(got.shape) == shape
        assert _rel(got.numpy(), want) < TOL
        assert _rel(got.numpy(), want_xla) < TOL
        # a CPU tensor takes the plain version: the kernel never launched
        assert idg_tile.launch_count(idg_tile.GRID_KERNEL) == 0

    def test_from_jax_records_round_trip(self, jref):
        # the reference prep's [nblk, 8, 256] blocks, converted: the port's
        # gridder on them matches the reference's on the same records
        shape, S = (N, 192), 32
        p, w, vis, _ = random_problem(61, shape=shape)
        jnp = jref.jnp
        recs_j, starts_j = jref.bin_records(
            shape, jnp.asarray(p), jnp.asarray(w), jnp.asarray(vis.real),
            jnp.asarray(vis.imag), subgrid=S)
        g_re, g_im = jref.grid_from_records(recs_j, starts_j, shape,
                                            theta=THETA, subgrid=S,
                                            interpret=True)
        want = np.asarray(g_re) + 1j * np.asarray(g_im)
        rows, starts = from_jax_tile_records(np.asarray(recs_j),
                                             np.asarray(starts_j))
        assert rows.shape[0] == 5 and rows.shape[1] % 256 == 0
        np.testing.assert_array_equal(
            rows.numpy(), np.asarray(recs_j).transpose(1, 0, 2)
            .reshape(8, -1)[:5])
        got = idg_tile.idg_grid_from_records(rows, starts, shape,
                                             theta=THETA, subgrid=S)
        assert _rel(got.numpy(), want) < TOL
        # and equals the port's gridder on its own prep
        own = idg_tile.idg_gridder_tile(shape, *_t(p, w, vis), theta=THETA,
                                        subgrid=S)
        assert _rel(got.numpy(), own.numpy()) < TOL


class TestDegridder:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("S,support", CASES)
    def test_matches_pallas(self, jref, S, support, shape):
        p, w, _, grid = random_problem(70 + S, shape=shape)
        jnp = jref.jnp
        want = np.asarray(jref.degridder(
            shape, jnp.asarray(p), jnp.asarray(w), jnp.asarray(grid),
            theta=THETA, subgrid=S, support=support, interpret=True))
        idg_tile.reset_launch_count()
        got = idg_tile.idg_degrid_tile(shape, *_t(p, w, grid), theta=THETA,
                                       subgrid=S, support=support).numpy()
        assert _rel(got, want) < TOL
        # out-of-bounds records predict exactly 0, the rest do not
        _, _, _, valid = idg_tile.prep_with_order(
            shape, *_t(p, w), subgrid=S, support=support)
        valid = valid.numpy()
        assert (~valid).sum() > 0
        assert np.all(got[~valid] == 0) and np.all(want[~valid] == 0)
        assert np.all(got[valid] != 0)
        assert idg_tile.launch_count(idg_tile.DEGRID_KERNEL) == 0

    @pytest.mark.parametrize("S,support", CASES)
    def test_adjoint_identity(self, S, support):
        shape = (N, 192)
        p, w, vis, G = random_problem(80 + S, shape=shape)
        pt, wt, vt, Gt = _t(p, w, vis, G)
        kw = dict(theta=THETA, subgrid=S, support=support)
        Av = idg_tile.idg_gridder_tile(shape, pt, wt, vt, **kw)
        AtG = idg_tile.idg_degrid_tile(shape, pt, wt, Gt, **kw)
        lhs = torch.vdot(Gt.reshape(-1).to(torch.complex128),
                         Av.reshape(-1).to(torch.complex128)).item()
        rhs = torch.vdot(AtG.to(torch.complex128),
                         vt.to(torch.complex128)).item()
        assert abs(lhs - rhs) / abs(lhs) < ADJ_TOL

    def test_from_jax_records_round_trip(self, jref):
        shape, S = (N, N), 48
        p, w, _, grid = random_problem(81, shape=shape)
        jnp = jref.jnp
        out_j = jref.prep_with_order(*_jax_geometry(shape, S),
                                     jnp.asarray(p), jnp.asarray(w), 15)
        recs, starts, order, valid = from_jax_tile_records(
            *[np.asarray(x) for x in out_j])
        assert tuple(recs.shape) == (3, p.shape[0])
        got = idg_tile.idg_degrid_from_records(
            recs, starts, order, torch.as_tensor(grid), theta=THETA,
            subgrid=S).numpy()
        want = np.asarray(jref.degridder(
            shape, jnp.asarray(p), jnp.asarray(w), jnp.asarray(grid),
            theta=THETA, subgrid=S, interpret=True))
        assert _rel(got, want) < TOL
        assert np.all(got[~valid.numpy()] == 0)


class TestStaged:
    @pytest.fixture(scope="class")
    def observation(self):
        from ska_sdp_tpu_torch.io.synthetic import (SyntheticConfig,
                                                    simulate_observation)

        return simulate_observation(SyntheticConfig(theta=THETA, lam=LAM,
                                                    nant=10, ntime=12))

    STAGES = ("preprocess", "bin+sort", "idg-kernel+fold",
              "hermitian+ifft+taper")

    @pytest.mark.parametrize("S,fov_pad", [(64, None), (32, 0.75)])
    def test_matches_unstaged_and_jax(self, jref, observation, S, fov_pad):
        from ska_sdp_tpu.models.dataset import _idg_staged as j_staged
        from ska_sdp_tpu.utils.timing import PhaseTimer as JPhaseTimer
        from ska_sdp_tpu_torch.io.inputs import vis_data_from_observation
        from ska_sdp_tpu_torch.models import dataset as ds
        from ska_sdp_tpu_torch.models import runs

        vd = vis_data_from_observation(observation)
        uvw, f, vis = ds.idg_inputs(vd, device="cpu")
        timer = PhaseTimer()
        idg_tile.reset_launch_count()
        img, mx = runs.idg_staged(uvw, f, vis, theta=THETA, lam=LAM,
                                  subgrid=S, taper_beta=12.0, timer=timer,
                                  fov_pad=fov_pad)
        img = img.numpy()
        assert img.shape == (N, N) and np.isfinite(img).all()
        assert mx == float(img.max())
        for stage in self.STAGES:
            assert timer.times[f"device/{stage}"] > 0
            assert f"device/{stage}+compile" in timer.times
        assert "device/dispatch-floor" in timer.times
        assert idg_tile.launch_count() == 0
        plain = ds.idg_image(vd, theta=THETA, lam=LAM, subgrid=S,
                             fov_pad=fov_pad, device="cpu").image.numpy()
        assert _rel(_crop(img), _crop(plain)) < IMG_TOL
        want, _ = j_staged(np.asarray(vd.uvw, np.float32),
                           np.float32(vd.frequency),
                           np.asarray(vd.vis, np.complex64), theta=THETA,
                           lam=LAM, subgrid=S, taper_beta=12.0,
                           timer=JPhaseTimer(), fov_pad=fov_pad)
        assert _rel(_crop(img), _crop(np.asarray(want))) < IMG_TOL

    def test_file_entry_device_phases(self, observation, tmp_path):
        from ska_sdp_tpu_torch.config import GridParams, ImagingConfig
        from ska_sdp_tpu_torch.io.synthetic import write_vis_file
        from ska_sdp_tpu_torch.models import runs

        path = str(tmp_path / "vis.h5")
        write_vis_file(path, observation)
        cfg = ImagingConfig(grid=GridParams(theta=THETA, lam=LAM))
        timer = PhaseTimer()
        mx, img = runs.idg_gridding(path, config=cfg, timer=timer,
                                    device_phases=True, device="cpu",
                                    outfile=str(tmp_path / "img.h5"))
        mx0, img0 = runs.idg_gridding(path, config=cfg, device="cpu")
        assert _rel(_crop(img), _crop(img0)) < IMG_TOL
        assert mx == float(img.max())
        for key in ("ingest/vis", "write/img", "device/dispatch-floor",
                    *(f"device/{s}" for s in self.STAGES)):
            assert key in timer.times

    def test_cli_device_phases(self, jref, tmp_path, capsys):
        from ska_sdp_tpu import cli as j_cli
        from ska_sdp_tpu_torch import cli
        from ska_sdp_tpu_torch.io import h5

        data = str(tmp_path / "obs")
        geo = ["--theta", str(THETA), "--lam", str(LAM)]
        assert cli.main(["--make-data", data, "--nant", "10", "--ntime",
                         "6", *geo]) == 0
        capsys.readouterr()
        out_t = str(tmp_path / "torch.h5")
        assert cli.main(["--mode", "idg", "--device-phases", "-i", data,
                         "--all", "-o", out_t, "--device", "cpu", *geo]) == 0
        lines = capsys.readouterr().out.splitlines()
        staged = [ln for ln in lines if ln.startswith("[device-phase]")]
        assert len(staged) == 1 + len(self.STAGES)
        for stage in ("dispatch-floor", *self.STAGES):
            assert any(stage in ln for ln in staged)
        assert any(ln.startswith("image max: ") for ln in lines)
        out_j = str(tmp_path / "jax.h5")
        assert j_cli.main(["--mode", "idg", "--device-phases", "-i", data,
                           "--all", "-o", out_j, "--backend", "cpu",
                           *geo]) == 0
        got = h5.read_dataset(out_t, "/img")
        want = h5.read_dataset(out_j, "/img")
        assert _rel(_crop(got), _crop(want)) < IMG_TOL
        # the other modes' staged drivers print their own stages
        assert cli.main(["--mode", "aw", "--idg", "--device-phases", "-i",
                         data, "--all", "--device", "cpu", *geo]) == 0
        assert "[device-phase] run-sort" in capsys.readouterr().out


class TestPhaseTimer:
    def test_accumulates_and_reports(self, capsys):
        timer = PhaseTimer(enabled=True)
        for _ in range(2):
            with timer.phase("ingest/vis"):
                pass
        assert list(timer.times) == ["ingest/vis"]
        assert timer.times["ingest/vis"] >= 0
        out = timer.device_stage("stage", lambda x: x + 1, torch.ones(3))
        torch.testing.assert_close(out, torch.full((3,), 2.0))
        timer.device_stage("stage", lambda: 0)
        assert set(timer.times) == {"ingest/vis", "device/stage",
                                    "device/stage+compile"}
        floor = timer.dispatch_floor()
        assert timer.times["device/dispatch-floor"] == floor > 0
        rep = timer.report().splitlines()
        assert len(rep) == 4 and all(ln.endswith(" ms") for ln in rep)
        printed = capsys.readouterr().out
        assert printed.count("[phase] ingest/vis") == 2
        assert printed.count("[device-phase] stage") == 2
        assert "[device-phase] dispatch-floor" in printed

    def test_env_switches(self, monkeypatch, tmp_path, capsys):
        monkeypatch.setenv("SKA_SDP_TPU_DUMP_PHASES", "1")
        monkeypatch.setenv("SKA_SDP_TPU_TRACE_DIR", str(tmp_path / "tr"))
        timer = PhaseTimer()
        assert timer.enabled and timer.trace_dir == str(tmp_path / "tr")
        with timer.phase("h2d+grid"):
            torch.ones(4).sum()
        assert "[phase] h2d+grid" in capsys.readouterr().out
        # the phase's trace and, beside it, the spans the phase logged
        traces = sorted(os.listdir(tmp_path / "tr"))
        assert len(traces) == 2 and traces[0].endswith(".json")
        assert traces[1] == traces[0][:-len(".json")] + ".spans.json"
        monkeypatch.delenv("SKA_SDP_TPU_DUMP_PHASES")
        monkeypatch.delenv("SKA_SDP_TPU_TRACE_DIR")
        quiet = PhaseTimer()
        assert not quiet.enabled and quiet.trace_dir is None


def _plain_route(recs, starts, shape, S, *, theta, order=None, grid=None):
    """The fixed-tile route's plain version on the records' device: the
    run table of :func:`idg_tile.tile_runs` through the streamed module's
    plain gridder (cropped as the wrapper crops it) or, with ``order`` and
    ``grid``, its plain degridder."""
    r = idg_tile.tile_runs(starts, shape, S)
    unit = torch.ones((1, S, S), dtype=torch.complex64, device=recs.device)
    if grid is None:
        g = stream.grid_from_records_plain(
            recs, r.starts_ext[:-1], r.starts_ext[1:], r.y0, r.x0, r.pair,
            r.pair, unit, grid_shape=shape, theta=theta, subgrid=S)
        return g[S:S + shape[0], S:S + shape[1]]
    return stream.degrid_from_records_plain(
        recs, r.starts_ext, r.y0, r.x0, r.pair, r.pair, order, grid, unit,
        theta=theta, subgrid=S)


@pytest.mark.cuda
class TestCudaKernels:
    @pytest.mark.parametrize("S", [16, 32, 48, 64, 128])
    def test_kernels_match_plain_on_card(self, cuda_device, S):
        # the route launches the streamed kernels, once each, and agrees
        # with their plain versions on the same run table
        support = min(15, S // 2 + 1)
        shape = (512, 384)
        p, w, vis, grid = random_problem(90 + S, b=20000, shape=shape)
        pt, wt, vt, gt = _t(p, w, vis, grid, device=cuda_device)
        kw = dict(theta=THETA, subgrid=S)
        recs, starts = idg_tile.idg_bin_records(
            shape, pt, wt, vt.real, vt.imag, subgrid=S, support=support)
        idg_tile.reset_launch_count()
        stream.reset_launch_count()
        k = idg_tile.idg_grid_from_records(recs, starts, shape, **kw)
        torch.cuda.synchronize()
        assert idg_tile.launch_count(idg_tile.GRID_KERNEL) == 1
        assert stream.launch_count(stream.GRID_KERNEL) == 1
        pl = _plain_route(recs, starts, shape, S, theta=THETA)
        assert _rel(k.cpu().numpy(), pl.cpu().numpy()) < TOL

        drecs, dstarts, order, valid = idg_tile.prep_with_order(
            shape, pt, wt, subgrid=S, support=support)
        v = idg_tile.idg_degrid_from_records(drecs, dstarts, order, gt, **kw)
        torch.cuda.synchronize()
        assert idg_tile.launch_count(idg_tile.DEGRID_KERNEL) == 1
        assert stream.launch_count(stream.DEGRID_KERNEL) == 1
        vp = _plain_route(drecs, dstarts, shape, S, theta=THETA, order=order,
                          grid=gt)
        vn, vpn = v.cpu().numpy(), vp.cpu().numpy()
        assert _rel(vn, vpn) < TOL
        assert np.all(vn[~valid.cpu().numpy()] == 0)

    def test_out_of_range_origin_raises_on_card(self, cuda_device):
        # records in a subgrid whose patch would leave the S-padded grid:
        # the gridder kernel skips and flags the run, the wrappers raise
        shape, S = (512, 384), 32
        geo = idg_tile.tile_geometry(shape, S)
        recs = torch.zeros((5, 4), device=cuda_device)
        recs[3] = 1.0
        drecs = torch.zeros((3, 4), device=cuda_device)
        order = torch.arange(4, dtype=torch.int32, device=cuda_device)
        grid = torch.ones(shape, dtype=torch.complex64, device=cuda_device)
        for t in (geo.n_sub - 1, geo.ntx - 1):
            bad = torch.zeros((geo.n_sub + 1,), dtype=torch.int32,
                              device=cuda_device)
            bad[t + 1:] = 4
            with pytest.raises(ValueError, match="origin"):
                idg_tile.idg_grid_from_records(recs, bad, shape, theta=THETA,
                                               subgrid=S)
            with pytest.raises(ValueError, match="origin"):
                idg_tile.idg_degrid_from_records(drecs, bad, order, grid,
                                                 theta=THETA, subgrid=S)
        torch.cuda.synchronize()
