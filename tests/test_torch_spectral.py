"""Port parity for spectral cubes (``--channels N``): the multi-channel
preps, the fold of the run-major IDG-AW pair (TPU kernels #5 and #6) into
the streamed pair's plain versions, per-channel gridding on both branches,
the three cube entries and the CLI.

Inputs come from numpy with a seed and go to both packages; the JAX side
runs as its own tests run it on the CPU (x64, Pallas ``interpret=True``;
its cube entries take their exact per-channel route there).  Bounds:

* exact: the preps' integer outputs (run tables, ``starts``, drop and mask
  counts, the ``live`` row); their float rows within 1e-6.  The fixed-tile
  prep's sort is not stable in the reference, so its rows are compared per
  subgrid in a canonical order;
* 5e-5 (rel-L2, the reference's between-route bound): the port's plain
  gridder and degridder against the run-major kernels #5 and #6 on the same
  records, and the bin-once route per channel on both branches;
* 1e-4 over the central 75% (IDG, IDG-AW) and 1e-5 (w) for the cubes
  against the JAX cube entries, with 0 drops on both sides: the bound also
  holds the binning approximation to the reference's own 1e-4.

On the CPU the wrappers take the plain versions; the ``cuda``-marked tests
hold the CUDA kernels to them on the same per-channel records and skip
without a card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch import cli
from ska_sdp_tpu_torch.config import GridParams, ImagingConfig
from ska_sdp_tpu_torch.io import h5, schema
from ska_sdp_tpu_torch.io.synthetic import SyntheticConfig, generate_dataset
from ska_sdp_tpu_torch.kernels import idg_aw_records as awr
from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
from ska_sdp_tpu_torch.kernels import idg_tile
from ska_sdp_tpu_torch.models import spectral
from ska_sdp_tpu_torch.ops.idg_aw import aw_screens_host
from ska_sdp_tpu_torch.utils.timing import PhaseTimer
from torch_jax_records import from_jax_run_records

torch.set_num_threads(2)

N, THETA, S = 256, 0.05, 64
TOL = 5e-5
IMG_TOL = 1e-4
W_TOL = 1e-5


@pytest.fixture(scope="module")
def j():
    """The JAX reference, imported only by the tests that compare with it,
    so the ``cuda`` tests also run where jax is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from ska_sdp_tpu import cli as j_cli
    from ska_sdp_tpu.kernels import idg_aw_degrid_pallas, idg_aw_pallas
    from ska_sdp_tpu.kernels import idg_pallas
    from ska_sdp_tpu.models import spectral as j_spectral
    from ska_sdp_tpu.utils.timing import PhaseTimer as JPhaseTimer

    return SimpleNamespace(jnp=jnp, aw=idg_aw_pallas,
                           aw_degrid=idg_aw_degrid_pallas, tile=idg_pallas,
                           spectral=j_spectral, cli=j_cli,
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


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(np.asarray(a), device=device) for a in arrays]


def track_problem(seed, nant=4, ntime=48, nchan=1, nvis=3, extent=0.25):
    """Baseline tracks (per-pair smooth uv drift, time-major, ``nchan``
    frequency-scaled rows per baseline inner), ``nvis`` random visibility
    planes ``[nvis, n]`` and random near-delta 15² A-kernels; the
    screens are ``[nant, 64, 64]`` complex128."""
    rng = np.random.default_rng(seed)
    ii, jj = np.triu_indices(nant, k=1)
    nbl = ii.shape[0]
    u0 = rng.uniform(-extent, extent, (nbl, 2))
    du = rng.uniform(-15.0 / N, 15.0 / N, (nbl, 2))
    w0 = rng.uniform(-250.0, 250.0, nbl)
    dw = rng.uniform(-20.0, 20.0, nbl)
    ft = (np.arange(ntime) / ntime)[:, None, None]
    fs = (1.0 + 0.002 * np.arange(nchan))[None, None, :]
    shape = (ntime, nbl, nchan)
    p = np.zeros((ntime * nbl * nchan, 3), np.float32)
    p[:, 0] = ((u0[None, :, 0:1] + du[None, :, 0:1] * ft) * fs).ravel()
    p[:, 1] = ((u0[None, :, 1:2] + du[None, :, 1:2] * ft) * fs).ravel()
    w = np.broadcast_to(w0[None, :, None] + dw[None, :, None] * ft,
                        shape).ravel().astype(np.float32)
    a1 = np.broadcast_to(ii[None, :, None], shape).ravel().astype(np.int32)
    a2 = np.broadcast_to(jj[None, :, None], shape).ravel().astype(np.int32)
    n = p.shape[0]
    vis = (rng.standard_normal((nvis, n))
           + 1j * rng.standard_normal((nvis, n))).astype(np.complex64)
    ak = np.zeros((nant, 15, 15), np.complex128)
    ak[:, 7, 7] = 1.0
    ak[:, 5:10, 5:10] += 0.1 * (rng.standard_normal((nant, 5, 5))
                                + 1j * rng.standard_normal((nant, 5, 5)))
    return SimpleNamespace(p=p, w=w, a1=a1, a2=a2, vis=vis, nbl=nbl, n=n,
                           nant=nant, ntime=ntime,
                           mr=8 * nbl + n // 128 + 64,
                           scr=aw_screens_host(ak, S))


def _pair_major(tp):
    """The track problem's records relaid pair-major (its ``nchan=1``
    raster transposed)."""
    pm = np.arange(tp.n).reshape(tp.ntime, tp.nbl).T.ravel()
    return SimpleNamespace(**{**vars(tp), "p": tp.p[pm], "w": tp.w[pm],
                              "a1": tp.a1[pm], "a2": tp.a2[pm],
                              "vis": tp.vis[:, pm]})


def _rows(recs, n):
    """The reference's ``[nblk, 8, C]`` blocks as ``[8, n]`` rows."""
    r = np.asarray(recs)
    return r.transpose(1, 0, 2).reshape(8, -1)[:, :n]


def _canonical(rows, starts):
    """Rows ``[k, m]`` of the first ``starts[-1]`` records, sorted within
    each subgrid lexicographically (an order both sorts agree on)."""
    m = int(starts[-1])
    seg = np.repeat(np.arange(starts.shape[0] - 1), np.diff(starts))
    r = rows[:, :m]
    return r[:, np.lexsort(tuple(r[::-1]) + (seg,))]


# ---------------------------------------------------------------------------
# 1. the preps: integers exact
# ---------------------------------------------------------------------------


def _aw_multi_both(j, tp, drift, ordered, max_runs):
    jnp = j.jnp
    out_j = j.aw.idg_aw_run_records_multi(
        (N, N), jnp.asarray(tp.p), jnp.asarray(tp.a1), jnp.asarray(tp.a2),
        jnp.asarray(tp.w), jnp.asarray(tp.vis.real),
        jnp.asarray(tp.vis.imag), subgrid=S, max_runs=max_runs,
        drift_cells=drift, ordered=ordered)
    p, a1, a2, w = _t(tp.p, tp.a1, tp.a2, tp.w)
    vis = torch.as_tensor(tp.vis)
    out = awr.idg_aw_run_records_multi(
        (N, N), p, a1, a2, w, vis.real, vis.imag, subgrid=S,
        max_runs=max_runs, drift_cells=drift, ordered=ordered)
    return out_j, out


class TestPreps:
    @pytest.mark.parametrize("drift,ordered,tight", [
        (0, False, False), (4, False, False), (4, True, False),
        (0, True, True)])
    def test_aw_run_records_multi(self, j, drift, ordered, tight):
        tp = track_problem(1 + drift, nvis=3)
        if ordered:
            tp = _pair_major(tp)
        # a tight run bound overflows: the drops and the live row count it
        mr = 3 if tight else tp.mr
        out_j, out = _aw_multi_both(j, tp, drift, ordered, mr)
        base_j, vis_j = np.asarray(out_j[0]), np.asarray(out_j[1])
        base, vis = out[0].numpy(), out[1].numpy()
        n = tp.n
        assert base.shape == (6, n) and vis.shape == (3, 2, n)
        for k, name in zip(range(2, 8), ("starts", "ends", "y0", "x0",
                                          "ia1", "ia2")):
            np.testing.assert_array_equal(out[k].numpy(),
                                          np.asarray(out_j[k]), name)
        assert int(out[8]) == int(out_j[8])
        assert (int(out[8]) > 0) == tight
        np.testing.assert_array_equal(base[5], base_j[5, :n])   # live
        np.testing.assert_allclose(base[:5], base_j[:5, :n], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(vis, vis_j[:, :, :n], rtol=1e-6,
                                   atol=1e-6)
        assert out[9] == tuple(out_j[9])

    @pytest.mark.parametrize("r", [0.97, 1.02, 1.3])
    def test_aw_records_for_channel(self, j, r):
        tp = track_problem(7, nvis=2)
        out_j, out = _aw_multi_both(j, tp, 4, False, tp.mr)
        recs_j, nm_j = j.aw.idg_aw_records_for_channel(out_j[0], out_j[1][1],
                                                       r, subgrid=S)
        recs, nm = awr.idg_aw_records_for_channel(out[0], out[1][1], r,
                                                  subgrid=S)
        assert recs.shape == (5, tp.n)
        assert int(nm) == int(nm_j)
        assert (int(nm) > 0) == (r == 1.3)
        np.testing.assert_allclose(recs.numpy(), _rows(recs_j, tp.n)[:5],
                                   rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("subgrid", [32, 64])
    def test_bin_records_multi(self, j, subgrid):
        rng = np.random.default_rng(20 + subgrid)
        b = 600
        p = rng.uniform(-0.45, 0.45, (b, 3)).astype(np.float32)
        p[:8, :2] = 0.53                              # some off the grid
        w = rng.uniform(-250.0, 250.0, b).astype(np.float32)
        vis = (rng.standard_normal((2, b))
               + 1j * rng.standard_normal((2, b))).astype(np.complex64)
        jnp = j.jnp
        base_j, vis_j, st_j = j.tile.idg_bin_records_multi(
            (N, N), jnp.asarray(p), jnp.asarray(w), jnp.asarray(vis.real),
            jnp.asarray(vis.imag), subgrid=subgrid)
        pt, wt, vt = _t(p, w, vis)
        base, vis_s, starts = idg_tile.idg_bin_records_multi(
            (N, N), pt, wt, vt.real, vt.imag, subgrid=subgrid)
        st = np.asarray(st_j)
        np.testing.assert_array_equal(starts.numpy(), st)
        assert 0 < st[-1] < b                          # some excluded
        rows_j = np.concatenate([np.asarray(base_j)[:, :b],
                                 np.asarray(vis_j)[:, :, :b].reshape(4, b)])
        rows = np.concatenate([base.numpy(), vis_s.numpy().reshape(4, b)])
        np.testing.assert_allclose(_canonical(rows, st),
                                   _canonical(rows_j, st), rtol=1e-6,
                                   atol=1e-6)
        assert not rows[5:, st[-1]:].any()              # excluded: dead
        for r in (0.97, 1.02, 1.3):
            recs_j, nm_j = j.tile.idg_records_for_channel(
                base_j, vis_j[1], r, subgrid=subgrid)
            recs, nm = idg_tile.idg_records_for_channel(base, vis_s[1], r,
                                                        subgrid=subgrid)
            assert int(nm) == int(nm_j), r
            if r == 1.3:
                assert int(nm) > 0
            np.testing.assert_allclose(
                _canonical(recs.numpy(), st),
                _canonical(_rows(recs_j, b)[:5], st), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# 2. the fold of the run-major pair (#5, #6)
# ---------------------------------------------------------------------------


class TestRunMajorFold:
    """Runs of 4 frequency-scaled rows per baseline and time, 10 pairs and
    64 times: several runs per 256-record block, some crossing blocks."""

    @pytest.fixture(scope="class")
    def tp(self):
        return track_problem(11, nant=5, ntime=64, nchan=4, nvis=1,
                             extent=0.3)

    def test_gridder_matches_run_major_kernel(self, j, tp, monkeypatch):
        monkeypatch.setenv("SKA_SDP_TPU_IDG_AW_KERNEL", "run")
        jnp = j.jnp
        recs, st, en, y0, x0, i1, i2, nd, _ = j.aw.idg_aw_run_records(
            (N, N), jnp.asarray(tp.p), jnp.asarray(tp.a1),
            jnp.asarray(tp.a2), jnp.asarray(tp.w),
            jnp.asarray(tp.vis[0].real), jnp.asarray(tp.vis[0].imag),
            subgrid=S, max_runs=tp.mr, layout="blocks")
        assert int(nd) == 0
        gr, gi = j.aw.idg_aw_grid_from_records(
            recs, st, en, y0, x0, i1, i2, (N, N),
            jnp.asarray(tp.scr.real, jnp.float32),
            jnp.asarray(tp.scr.imag, jnp.float32), theta=THETA, subgrid=S,
            interpret=True)
        want = np.asarray(gr) + 1j * np.asarray(gi)
        ported = from_jax_run_records(*[np.asarray(x) for x in (
            recs, st, en, y0, x0, i1, i2, nd)])
        scr = torch.as_tensor(tp.scr.astype(np.complex64))
        got = stream.grid_from_records_plain(
            *ported[:7], scr, grid_shape=(N, N), theta=THETA, subgrid=S)
        assert _rel(got[S:S + N, S:S + N].numpy(), want) < TOL
        # and the port's own prep and gridder on the same inputs
        p, a1, a2, w, v = _t(tp.p, tp.a1, tp.a2, tp.w, tp.vis[0])
        own, nd_own = stream.idg_aw_gridder_stream(
            (N, N), p, a1, a2, w, v, scr, theta=THETA, subgrid=S,
            max_runs=tp.mr)
        assert int(nd_own) == 0
        assert _rel(own.numpy(), want) < TOL

    def test_degridder_matches_run_major_kernel(self, j, tp, monkeypatch):
        monkeypatch.setenv("SKA_SDP_TPU_IDG_AW_KERNEL", "run")
        rng = np.random.default_rng(12)
        grid = (rng.standard_normal((N, N))
                + 1j * rng.standard_normal((N, N))).astype(np.complex64)
        jnp = j.jnp
        v_re, v_im, nd_j = j.aw_degrid.idg_aw_degrid_pallas(
            (N, N), jnp.asarray(tp.p), jnp.asarray(tp.a1),
            jnp.asarray(tp.a2), jnp.asarray(tp.w), jnp.asarray(grid.real),
            jnp.asarray(grid.imag), jnp.asarray(tp.scr.real, jnp.float32),
            jnp.asarray(tp.scr.imag, jnp.float32), theta=THETA, subgrid=S,
            max_runs=tp.mr, interpret=True)
        want = np.asarray(v_re) + 1j * np.asarray(v_im)
        p, a1, a2, w, g = _t(tp.p, tp.a1, tp.a2, tp.w, grid)
        got, nd = stream.idg_aw_degridder_stream(
            (N, N), p, a1, a2, w, g,
            torch.as_tensor(tp.scr.astype(np.complex64)), theta=THETA,
            subgrid=S, max_runs=tp.mr)
        assert int(nd) == int(nd_j) == 0
        assert _rel(got.numpy(), want) < TOL


# ---------------------------------------------------------------------------
# 3. per-channel gridding: the bin-once route on both branches
# ---------------------------------------------------------------------------


class TestPerChannel:
    def test_streamed_branch(self, j):
        tp = track_problem(21, nvis=2)
        out_j, out = _aw_multi_both(j, tp, 4, False, tp.mr)
        jnp = j.jnp
        sre = jnp.asarray(tp.scr.real, jnp.float32)
        sim = jnp.asarray(tp.scr.imag, jnp.float32)
        scr = torch.as_tensor(tp.scr.astype(np.complex64))
        for c, r in enumerate((0.97, 1.02)):
            recs_j, nm_j = j.aw.idg_aw_records_for_channel(
                out_j[0], out_j[1][c], r, subgrid=S)
            gr, gi = j.aw.idg_aw_grid_from_records(
                recs_j, *out_j[2:8], (N, N), sre, sim, theta=THETA,
                subgrid=S, interpret=True)
            want = np.asarray(gr) + 1j * np.asarray(gi)
            recs, nm = awr.idg_aw_records_for_channel(out[0], out[1][c], r,
                                                      subgrid=S)
            got = stream.idg_aw_grid_from_records_stream(
                recs, *out[2:8], (N, N), scr, theta=THETA, subgrid=S)
            assert int(nm) == int(nm_j) == 0
            assert _rel(got.numpy(), want) < TOL, r

    @pytest.mark.parametrize("subgrid", [32, 64])
    def test_fixed_tile_branch(self, j, subgrid):
        rng = np.random.default_rng(30 + subgrid)
        b = 400
        p = rng.uniform(-0.3, 0.3, (b, 3)).astype(np.float32)
        w = rng.uniform(-250.0, 250.0, b).astype(np.float32)
        vis = (rng.standard_normal((2, b))
               + 1j * rng.standard_normal((2, b))).astype(np.complex64)
        jnp = j.jnp
        base_j, vis_j, st_j = j.tile.idg_bin_records_multi(
            (N, N), jnp.asarray(p), jnp.asarray(w), jnp.asarray(vis.real),
            jnp.asarray(vis.imag), subgrid=subgrid)
        pt, wt, vt = _t(p, w, vis)
        base, vis_s, starts = idg_tile.idg_bin_records_multi(
            (N, N), pt, wt, vt.real, vt.imag, subgrid=subgrid)
        # S=32's centred window has no slack below: r = 1 there
        ratios = (1.0, 1.0) if subgrid == 32 else (0.99, 1.01)
        for c, r in enumerate(ratios):
            recs_j, nm_j = j.tile.idg_records_for_channel(
                base_j, vis_j[c], r, subgrid=subgrid)
            gr, gi = j.tile.idg_grid_from_records(
                recs_j, st_j, (N, N), theta=THETA, subgrid=subgrid,
                interpret=True)
            want = np.asarray(gr) + 1j * np.asarray(gi)
            recs, nm = idg_tile.idg_records_for_channel(
                base, vis_s[c], r, subgrid=subgrid)
            got = idg_tile.idg_grid_from_records(
                recs, starts, (N, N), theta=THETA, subgrid=subgrid)
            assert int(nm) == int(nm_j) == 0
            assert _rel(got.numpy(), want) < TOL, r


# ---------------------------------------------------------------------------
# 4. the cube entries against the JAX ones
# ---------------------------------------------------------------------------


CFG = SyntheticConfig(
    theta=0.05, lam=3600, nant=6, ntime=48, nsources=3, nw_planes=4,
    qpx=4, npix_ff=128, npix_kern=15, seed=11, nchan=4, chan_bw=2.0e6,
)
# 1200²: S=32's tile bound passes the run-table cap, the fixed-tile branch
CFG32 = SyntheticConfig(
    theta=0.05, lam=24000, nant=6, ntime=48, nsources=3, nw_planes=4,
    qpx=4, npix_ff=128, npix_kern=15, seed=12, nchan=4, chan_bw=2.0e6,
)


@pytest.fixture(scope="module")
def cube_data(tmp_path_factory):
    paths, _ = generate_dataset(str(tmp_path_factory.mktemp("cube")), CFG)
    return paths


def _run_both(j, mode, paths, cfg, tmp_path, **kw):
    """The port's and the JAX file entry's ``(mx, img, cube, dropped, /img,
    /img_cube)`` on the CPU, each writing its own file."""
    icfg = ImagingConfig(grid=GridParams(theta=cfg.theta, lam=cfg.lam))
    from ska_sdp_tpu.config import GridParams as JGridParams
    from ska_sdp_tpu.config import ImagingConfig as JImagingConfig

    jcfg = JImagingConfig(grid=JGridParams(theta=cfg.theta, lam=cfg.lam))
    args = {"idg": (paths["vis"],),
            "aw": (paths["akern"], paths["vis"]),
            "w": (paths["wkern"], paths["vis"])}[mode]
    name = {"idg": "idg_gridding_multi", "aw": "aw_idg_gridding_multi",
            "w": "w_gridding_multi"}[mode]
    out = {}
    for side, fn, conf, timer, extra in (
            ("t", getattr(spectral, name), icfg, PhaseTimer(),
             dict(device="cpu")),
            ("j", getattr(j.spectral, name), jcfg, j.PhaseTimer(), {})):
        f = str(tmp_path / f"{side}.h5")
        mx, img, cube = fn(*args, cfg.nchan, outfile=f, config=conf,
                           timer=timer, **kw, **extra)
        out[side] = SimpleNamespace(
            mx=mx, img=img, cube=cube,
            dropped=timer.counters.get("multichannel/dropped", 0.0),
            f_img=h5.read_dataset(f, schema.IMG_DATASET),
            f_cube=h5.read_dataset(f, schema.IMG_CUBE_DATASET))
    return out["t"], out["j"]


class TestCubeEntries:
    @pytest.mark.parametrize("exact", [False, True])
    @pytest.mark.parametrize("mode", ["idg", "aw", "w"])
    def test_matches_jax_entry(self, j, cube_data, tmp_path, monkeypatch,
                                mode, exact):
        if exact:
            monkeypatch.setenv("SKA_SDP_TPU_EXACT_WEIGHTS", "1")
        t, jj = _run_both(j, mode, cube_data, CFG, tmp_path)
        n = int(round(CFG.theta * CFG.lam))
        assert t.cube.shape == jj.cube.shape == (CFG.nchan, n, n)
        assert t.dropped == jj.dropped == 0
        for c in range(CFG.nchan):
            if mode == "w":
                assert _rel(t.cube[c], jj.cube[c]) < W_TOL, c
            else:
                assert _rel(_crop(t.cube[c]), _crop(jj.cube[c])) < IMG_TOL, c
        # the file layout: the channel mean and the cube, float64
        for side in (t, jj):
            assert side.f_cube.shape == (CFG.nchan, n, n)
            assert side.f_img.shape == (n, n)
            assert side.f_cube.dtype == side.f_img.dtype == np.float64
        np.testing.assert_array_equal(t.f_cube, t.cube.astype(np.float64))
        np.testing.assert_allclose(t.f_img, t.cube.mean(axis=0), rtol=1e-6,
                                   atol=1e-7)
        assert t.mx == float(t.img.max())

    def test_idg_s32_takes_fixed_tile_branch(self, j, tmp_path):
        paths, obs = generate_dataset(str(tmp_path / "d32"), CFG32)
        from ska_sdp_tpu_torch.io.inputs import vis_data_from_observation

        res = spectral.idg_cube(vis_data_from_observation(obs), theta=0.05,
                                lam=CFG32.lam, subgrid=32, device="cpu")
        assert set(res.branches) == {"tile"}
        assert res.dropped.tolist() == [0] * CFG32.nchan
        t, jj = _run_both(j, "idg", paths, CFG32, tmp_path, subgrid=32)
        assert t.dropped == jj.dropped == 0
        np.testing.assert_array_equal(t.cube, res.cube.numpy())
        for c in range(CFG32.nchan):
            assert _rel(_crop(t.cube[c]), _crop(jj.cube[c])) < IMG_TOL, c

    def test_plan_and_extent_match_reference(self, j):
        rng = np.random.default_rng(3)
        uvw = rng.uniform(-3000, 3000, (500, 3))
        for freqs, ext, slack in (
                (1.5e8 + 1e5 * np.arange(16), 1000.0, 6.0),
                (1.5e8 * (1.0 + 0.4 * np.arange(32) / 31), 100.0, 3.0),
                (np.array([1e8, 2e8, 3e8]), 1e6, 1.0)):
            assert (spectral.plan_channel_groups(freqs, ext, slack)
                    == j.spectral.plan_channel_groups(freqs, ext, slack))
        assert (spectral.uv_extent_cells(uvw, 1.6e8, 3600, 180)
                == j.spectral.uv_extent_cells(uvw, 1.6e8, 3600, 180))

    def test_drops_are_counted_and_warned(self, capsys):
        timer = PhaseTimer()
        spectral._surface_drops(np.array([0, 3, 1]), 100, timer)
        assert timer.counters["multichannel/dropped"] == 4.0
        err = capsys.readouterr().err
        assert "dropped 4 channel-records (4.000% of" in err
        assert "per-channel counts: 0,3,1" in err
        spectral._surface_drops(np.zeros(2, np.int64), 100, timer)
        assert timer.counters["multichannel/dropped"] == 0.0
        assert capsys.readouterr().err == ""


# ---------------------------------------------------------------------------
# 5. the CLI
# ---------------------------------------------------------------------------


GEO = ["--theta", "0.05", "--lam", "1600"]


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli") / "obs")
    assert cli.main(["--make-data", d, "--nant", "6", "--ntime", "8",
                     "--nw", "4", "--qpx", "2", "--nchan", "4", *GEO]) == 0
    return d


class TestCLI:
    @pytest.mark.parametrize("mode", [["--mode", "idg"], ["--mode", "w"],
                                      ["--mode", "aw", "--idg"]])
    def test_channels_match_jax_cli(self, j, cli_data, tmp_path, capsys,
                                    mode):
        out = {}
        for side, main, dev in (("t", cli.main, ["--device", "cpu"]),
                                ("j", j.cli.main, ["--backend", "cpu"])):
            f = str(tmp_path / f"{side}.h5")
            assert main([*mode, "-i", cli_data, "--all", "--channels", "4",
                         "-o", f, *dev, *GEO]) == 0
            line = capsys.readouterr().out.splitlines()[-1]
            assert line.startswith("imaged 4 channels, continuum image max: ")
            out[side] = (float(line.rsplit(" ", 1)[1]),
                         h5.read_dataset(f, schema.IMG_CUBE_DATASET),
                         h5.read_dataset(f, schema.IMG_DATASET))
        (mx, cube, img), (_, cube_j, img_j) = out["t"], out["j"]
        assert cube.shape == cube_j.shape == (4, 80, 80)
        assert img.shape == img_j.shape == (80, 80)
        tol = W_TOL if mode[1] == "w" else IMG_TOL
        crop = (lambda a: a) if mode[1] == "w" else _crop
        for c in range(4):
            assert _rel(crop(cube[c]), crop(cube_j[c])) < tol, c
        np.testing.assert_allclose(img, cube.mean(axis=0), rtol=1e-6,
                                   atol=1e-7)
        assert mx == float(img.max())

    @pytest.mark.parametrize("mode", [["--mode", "aw"],
                                      ["--mode", "predict"]])
    def test_channels_refused_elsewhere(self, cli_data, capsys, mode):
        assert cli.main([*mode, "-i", cli_data, "--all", "--channels", "4",
                         "--device", "cpu", *GEO]) == 1
        assert ("--channels supports --mode w, --mode idg and --mode aw "
                "--idg") in capsys.readouterr().err

    @pytest.mark.parametrize("argv", [
        ["--backend", "tpu"], ["--gridder", "xla"], ["--gridder", "pallas"],
        ["--gridder", "auto"], ["--xla-dump", "dump"],
        ["--xla-dump", "dump", "--channels", "4"]])
    def test_reference_flags_refused(self, argv, capsys):
        assert cli.main(["--mode", "idg", *argv]) == 2
        assert f"{argv[0]}" in capsys.readouterr().err

    def test_backend_cpu_and_trace_dir(self, cli_data, tmp_path, capsys):
        trace = tmp_path / "trace"
        assert cli.main(["--mode", "idg", "-i", cli_data, "--all",
                         "--backend", "cpu", "--channels", "4",
                         "--trace-dir", str(trace), *GEO]) == 0
        assert "imaged 4 channels" in capsys.readouterr().out
        traces = sorted(p.name for p in trace.iterdir())
        assert any(t.startswith("compile+grid+fft") for t in traces)
        assert all(t.endswith(".json") for t in traces)
        assert cli.main(["--mode", "w", "-i", cli_data, "--all",
                         "--backend", "cpu", "--trace-dir", str(trace),
                         *GEO]) == 0
        # the file entry's own phases are traced
        assert any(p.name.startswith("h2d+compile+grid+fft")
                   for p in trace.iterdir())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
class TestCudaKernels:
    @pytest.mark.parametrize("drift", [0, 4])
    def test_streamed_records_on_card(self, cuda_device, drift):
        tp = track_problem(41 + drift, nant=16, ntime=256, nvis=2,
                           extent=0.4)
        p, a1, a2, w, vis = _t(tp.p, tp.a1, tp.a2, tp.w, tp.vis,
                               device=cuda_device)
        scr = torch.as_tensor(tp.scr.astype(np.complex64),
                              device=cuda_device)
        base, vis_s, *runs, nd, _ = awr.idg_aw_run_records_multi(
            (512, 512), p / 2, a1, a2, w, vis.real, vis.imag, subgrid=S,
            max_runs=tp.mr, drift_cells=drift)
        assert int(nd) == 0
        for c, r in enumerate((0.97, 1.03)):
            recs, _ = awr.idg_aw_records_for_channel(base, vis_s[c], r,
                                                     subgrid=S)
            stream.reset_launch_count()
            k = stream.idg_aw_grid_from_records_stream(
                recs, *runs, (512, 512), scr, theta=THETA, subgrid=S)
            torch.cuda.synchronize()
            assert stream.launch_count(stream.GRID_KERNEL) == 1
            pl = stream.grid_from_records_plain(
                recs, *runs, scr, grid_shape=(512, 512), theta=THETA,
                subgrid=S)[S:S + 512, S:S + 512]
            assert _rel(k.cpu().numpy(), pl.cpu().numpy()) < TOL

    def test_fixed_tile_records_on_card(self, cuda_device):
        rng = np.random.default_rng(50)
        b = 20000
        p = rng.uniform(-0.45, 0.45, (b, 3)).astype(np.float32)
        w = rng.uniform(-250.0, 250.0, b).astype(np.float32)
        vis = (rng.standard_normal((2, b))
               + 1j * rng.standard_normal((2, b))).astype(np.complex64)
        pt, wt, vt = _t(p, w, vis, device=cuda_device)
        shape = (512, 512)
        base, vis_s, starts = idg_tile.idg_bin_records_multi(
            shape, pt, wt, vt.real, vt.imag, subgrid=32)
        recs, _ = idg_tile.idg_records_for_channel(base, vis_s[0], 1.0,
                                                   subgrid=32)
        idg_tile.reset_launch_count()
        stream.reset_launch_count()
        k = idg_tile.idg_grid_from_records(recs, starts, shape, theta=THETA,
                                           subgrid=32)
        torch.cuda.synchronize()
        assert idg_tile.launch_count(idg_tile.GRID_KERNEL) == 1
        assert stream.launch_count(stream.GRID_KERNEL) == 1
        # the streamed plain gridder on the route's run table
        r = idg_tile.tile_runs(starts, shape, 32)
        unit = torch.ones((1, 32, 32), dtype=torch.complex64,
                          device=cuda_device)
        pl = stream.grid_from_records_plain(
            recs, r.starts_ext[:-1], r.starts_ext[1:], r.y0, r.x0, r.pair,
            r.pair, unit, grid_shape=shape, theta=THETA,
            subgrid=32)[32:32 + 512, 32:32 + 512]
        assert _rel(k.cpu().numpy(), pl.cpu().numpy()) < TOL
