"""Port parity for the fused AW-projection slice (``--mode aw``, the
default): the AW kernel algebra, the plain scatter, the fused gridder's
records and tables, its plain version against the three Pallas kernels it
stands for, the imaging program and the CLI.

Inputs come from numpy with a seed and go to both packages; the JAX side
runs as its own tests run it on the CPU (x64, Pallas ``interpret=True``).
Bounds:

* exact: ``next_pow2``, the analysis and synthesis matrices, the records'
  integer fields;
* 1e-12 (complex128): ``ops/convolution.py`` against the JAX module for
  s ∈ {4, 7, 15} (matrix sandwiches) and s = 65 (m = 256: the FFT branch);
  the pair and w-tap tables;
* 1e-10 (complex128) and 5e-5 (complex64): ``ops.gridding.convgrid_aw``
  against the JAX ``ops.convgrid_aw``, records beyond the edges;
* 5e-5 (float32, the reference's between-route bound): ``aw_fused_plain``
  against the resident (#13), tiled (#14) and slab-placement (#15) Pallas
  kernels at the ``exact`` precision tier.  #14 and #15 fold into the one
  CUDA kernel, so agreeing with all three is the CPU half of the fold's
  evidence;
* 1e-8 (float64) and 1e-4 (float32): ``_aw_pipeline`` against the JAX
  ``_aw_pipeline``; 1e-4 over the central 75% for the CLI;
* 1e-10 (complex128): ``synthesis_fft``, the FFT shape the kernel
  computes, against the dense ``_sandwich(S, X)`` for every m of the
  envelope; exact: the pair plan's integers against a numpy brute force;
  1e-12 (complex128): a plain accumulation in plan order against
  ``aw_fused_plain``.

On the CPU the wrappers take the plain versions; the CUDA kernel is held
to ``aw_fused_plain`` by the ``cuda``-marked tests (rel-L2 ≤ 5e-5: float32
sums taken in atomic order), which skip without a card.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch import cli, kernels
from ska_sdp_tpu_torch.io import h5, synthetic
from ska_sdp_tpu_torch.kernels import aw_fused
from ska_sdp_tpu_torch.models import dataset as ds
from ska_sdp_tpu_torch.ops import convolution as conv
from ska_sdp_tpu_torch.ops.fourier import next_pow2
from ska_sdp_tpu_torch.ops.gridding import convgrid_aw

torch.set_num_threads(2)

THETA, LAM, N = 0.05, 5120, 256
GEO = ["--theta", str(THETA), "--lam", str(LAM)]
CUDA_TOL = 5e-5


@pytest.fixture(scope="module")
def j():
    """The JAX reference, imported only by the tests that compare with it,
    so the ``cuda`` tests also run where jax is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from ska_sdp_tpu import cli as j_cli
    from ska_sdp_tpu import ops
    from ska_sdp_tpu.kernels import aw_fused_pallas as tiled
    from ska_sdp_tpu.kernels import aw_fused_resident_pallas as resident
    from ska_sdp_tpu.kernels import patch_scatter_pallas as slab
    from ska_sdp_tpu.models import dataset as j_ds
    from ska_sdp_tpu.ops import convolution
    from ska_sdp_tpu.ops import fourier

    return SimpleNamespace(jnp=jnp, ops=ops, conv=convolution,
                           fourier=fourier, resident=resident, tiled=tiled,
                           slab=slab, ds=j_ds, cli=j_cli)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _cplx(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _crop(a):
    n = a.shape[0]
    return a[n // 8:n - n // 8, n // 8:n - n // 8]


def problem(rng, b=300, nant=6, nw=3, qpx=4, s=15, lim=0.53,
            dtype=np.complex128):
    """Random bank, A-kernels and records, some beyond the grid's edges
    (``|p| ≤ lim``), as numpy arrays."""
    rdt = np.float64 if dtype == np.complex128 else np.float32
    return SimpleNamespace(
        wk=_cplx(rng, (nw, qpx, qpx, s, s), dtype),
        ak=_cplx(rng, (nant, s, s), dtype),
        p=rng.uniform(-lim, lim, (b, 3)).astype(rdt),
        wbin=rng.integers(0, nw, b).astype(np.int32),
        a1=rng.integers(0, nant, b).astype(np.int32),
        a2=rng.integers(0, nant, b).astype(np.int32),
        vis=_cplx(rng, b, dtype), nant=nant, nw=nw, qpx=qpx, s=s)


def _t(pr, device="cpu"):
    return [torch.as_tensor(getattr(pr, k), device=device)
            for k in ("wk", "ak", "p", "wbin", "a1", "a2", "vis")]


def _records_tables(pr, shape, device="cpu", remap=False):
    """Records and tables over every pair, or (``remap``) as the card's
    route builds them, over the pairs that occur."""
    wk, ak, p, wbin, a1, a2, vis = _t(pr, device)
    if remap:
        return (*aw_fused.aw_records_tables(wk, ak, shape, p, wbin, a1, a2),
                vis)
    rec = aw_fused.aw_records(shape, pr.qpx, pr.s, pr.nant,
                              pr.nw * pr.qpx ** 2, p, wbin, a1, a2)
    return (rec, *aw_fused.aw_tables(wk, ak), vis)


# ---------------------------------------------------------------------------
# ops/convolution.py
# ---------------------------------------------------------------------------


class TestConvolution:
    @pytest.mark.parametrize("x", [1, 2, 3, 7, 29, 31, 33, 129])
    def test_next_pow2(self, j, x):
        assert next_pow2(x) == j.fourier.next_pow2(x)

    @pytest.mark.parametrize("s", [4, 7, 15, 65])
    def test_matrices_equal_exactly(self, j, s):
        m = next_pow2(2 * s - 1)
        np.testing.assert_array_equal(conv._analysis_mat(s, m),
                                      j.conv._analysis_mat(s, m))
        np.testing.assert_array_equal(conv._synthesis_mat(s, m),
                                      j.conv._synthesis_mat(s, m))

    @pytest.mark.parametrize("fn", ["convolve2d", "convolve2d_cheap",
                                    "aw_kernel", "akernel_spectra",
                                    "wkernel_tap_spectra",
                                    "make_aw_kernels_batched"])
    @pytest.mark.parametrize("s", [4, 7, 15, 65])
    def test_matches_jax(self, j, fn, s):
        rng = np.random.default_rng(s)
        a, b, c = (_cplx(rng, (3, s, s)) for _ in range(3))
        wk = _cplx(rng, (2, 2, 2, s, s))
        J, T = j.jnp.asarray, torch.as_tensor
        if fn in ("convolve2d", "convolve2d_cheap"):
            args = (a, b)
        elif fn == "aw_kernel":
            args = (a, b, c)
        elif fn == "akernel_spectra":
            args = (a,)
        elif fn == "wkernel_tap_spectra":
            args = (wk,)
        if fn != "make_aw_kernels_batched":
            got = getattr(conv, fn)(*map(T, args)).numpy()
            want = np.asarray(getattr(j.conv, fn)(*map(J, args)))
        else:
            idx = [rng.integers(0, k, 5).astype(np.int32)
                   for k in (3, 3, 2, 2, 2)]
            a_spec = np.array(j.conv.akernel_spectra(J(a)))
            w_spec = np.array(j.conv.wkernel_tap_spectra(J(wk)))
            got = conv.make_aw_kernels_batched(s)(
                T(a_spec), T(w_spec), *map(T, idx)).numpy()
            want = np.asarray(j.conv.make_aw_kernels_batched(s)(
                J(a_spec), J(w_spec), *map(J, idx)))
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-12


# ---------------------------------------------------------------------------
# ops.gridding.convgrid_aw (the CPU route of kernels.aw_gridder)
# ---------------------------------------------------------------------------


class TestConvgridAW:
    @pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-10),
                                           (np.complex64, 5e-5)])
    @pytest.mark.parametrize("s", [7, 15])
    def test_matches_jax(self, j, dtype, tol, s):
        rng = np.random.default_rng(3)
        pr = problem(rng, 400, s=s, dtype=dtype)
        shape = (200, 180)
        want = np.asarray(j.ops.convgrid_aw(
            *(j.jnp.asarray(x) for x in (pr.wk, pr.ak)),
            j.jnp.zeros(shape, dtype),
            *(j.jnp.asarray(x) for x in (pr.p, pr.wbin, pr.a1, pr.a2,
                                         pr.vis)), chunk=128))
        wk, ak, p, wbin, a1, a2, vis = _t(pr)
        got = convgrid_aw(wk, ak, torch.zeros(shape, dtype=vis.dtype), p,
                          wbin, a1, a2, vis, chunk=96)
        assert got.dtype == vis.dtype
        assert _rel(got.numpy(), want) <= tol
        # the dispatch takes the same route on the CPU
        guv = torch.zeros(shape, dtype=vis.dtype)
        via = kernels.aw_gridder(wk, ak, guv, p, wbin, a1, a2, vis,
                                 chunk=96)
        np.testing.assert_array_equal(via.numpy(), got.numpy())
        assert not guv.abs().any()


# ---------------------------------------------------------------------------
# kernels/aw_fused.py: records, tables, the plain version
# ---------------------------------------------------------------------------


class TestRecordsAndTables:
    @pytest.mark.parametrize("shape", [(256, 256), (120, 200)])
    def test_records_match_jax_pack(self, j, shape, monkeypatch):
        rng = np.random.default_rng(5)
        pr = problem(rng, 300, lim=0.6, dtype=np.complex64)
        rec, _, _, _ = _records_tables(pr, shape)
        vis = j.jnp.asarray(pr.vis)
        packed = np.asarray(j.resident._pack_records(
            shape, pr.qpx, pr.s, pr.nant, j.jnp.asarray(pr.p),
            j.jnp.asarray(pr.wbin), j.jnp.asarray(pr.a1),
            j.jnp.asarray(pr.a2), j.jnp.real(vis), j.jnp.imag(vis)))
        fields = packed.transpose(1, 0, 2).reshape(8, -1)[:, :300]
        pad = j.resident.PAD
        valid = rec.valid.numpy()
        assert 0 < valid.sum() < 300          # some records past the edges
        np.testing.assert_array_equal(
            fields[0], np.where(valid, rec.y0.numpy() + pad, 0))
        np.testing.assert_array_equal(
            fields[1], np.where(valid, rec.x0.numpy() + pad, 0))
        np.testing.assert_array_equal(fields[2], rec.pid.numpy())
        np.testing.assert_array_equal(fields[3], rec.kidx.numpy())
        np.testing.assert_array_equal(fields[4] != 0,
                                      valid & (pr.vis.real != 0))

    def test_tables_match_jax(self, j):
        rng = np.random.default_rng(6)
        pr = problem(rng, 50)
        J = j.jnp.asarray
        s, nant = pr.s, pr.nant
        a_spec = j.conv.akernel_spectra(J(pr.ak))
        m = a_spec.shape[-1]
        T = j.conv._analysis_mat(s, m) @ j.conv._synthesis_mat(s, m)
        want_pair = np.asarray(j.conv._sandwich(
            T, a_spec[:, None] * a_spec[None, :])).reshape(nant * nant, m, m)
        want_w = np.asarray(j.conv.wkernel_tap_spectra(J(pr.wk))).reshape(
            -1, m, m)
        rec, pt, ws, _ = _records_tables(pr, (64, 64))
        assert pt.shape == (nant * nant, m, m) and pt.dtype == torch.complex128
        assert _rel(pt.numpy(), want_pair) <= 1e-12
        assert _rel(ws.numpy(), want_w) <= 1e-12
        # the card's table over the pairs that occur: the same rows
        rec_u, pt_u, _, _ = _records_tables(pr, (64, 64), remap=True)
        assert pt_u.shape[0] == len(np.unique(rec.pid.numpy())) < nant * nant
        np.testing.assert_array_equal(pt_u[rec_u.pid.long()].numpy(),
                                      pt[rec.pid.long()].numpy())

    @pytest.mark.parametrize("s", [4, 7, 15])
    def test_plain_matches_convgrid_aw(self, s):
        """Tables and records, remapped pairs included, give the per-
        visibility scatter's grid (the TPU cannot pack s = 4; the CUDA
        kernel serves it)."""
        rng = np.random.default_rng(7 + s)
        pr = problem(rng, 300, s=s)
        shape = (150, 170)
        rec, pt, ws, vis = _records_tables(pr, shape, remap=True)
        got = aw_fused.aw_fused_plain(pt, ws, rec, vis, shape, chunk=64)
        wk, ak, p, wbin, a1, a2, _ = _t(pr)
        want = convgrid_aw(wk, ak, torch.zeros(shape, dtype=vis.dtype), p,
                           wbin, a1, a2, vis)
        assert _rel(got.numpy(), want.numpy()) <= 1e-12
        # the kernel's wrapper takes the plain version for CPU tensors
        init = torch.ones(shape, dtype=vis.dtype)
        via = aw_fused.aw_fused_grid(pt, ws, rec, vis, shape, init=init)
        assert _rel(via.numpy(), (got + 1).numpy()) <= 1e-12


def _brute_pair_plan(rec, shape, npair, window):
    """The kernel's work by brute force: the valid records by pair in
    input order, and the (pair, first, end) runs of one pair inside each
    window of ``window`` positions."""
    H, W = shape
    s = rec.support
    y0, x0 = rec.y0.numpy(), rec.x0.numpy()
    valid = (y0 > -s) & (y0 < H) & (x0 > -s) & (x0 < W)
    key = np.where(valid, np.clip(rec.pid.numpy(), 0, npair - 1), npair)
    order = np.argsort(key, kind="stable")
    skey = key[order]
    items = []
    for w in range(0, len(key), window):
        for e in range(w, min(w + window, len(key))):
            if skey[e] == npair:
                break
            if e == w or skey[e] != skey[e - 1]:
                items.append([int(skey[e]), e, e + 1])
            else:
                items[-1][2] = e + 1
    return order[:valid.sum()], [tuple(i) for i in items]


class TestPairPlan:
    """The algebra and the work plan of ``csrc/aw_grid.cu``, on the CPU."""

    @pytest.mark.parametrize("s", [1, 2, 4, 8, 15, 16, 32])
    def test_synthesis_fft_equals_the_dense_sandwich(self, s):
        m = next_pow2(2 * s - 1)
        X = torch.as_tensor(_cplx(np.random.default_rng(s), (3, m, m)))
        want = conv._sandwich(conv._synthesis_mat(s, m), X)
        got = aw_fused.synthesis_fft(X, s)
        assert got.shape == want.shape == (3, s, s)
        assert _rel(got.numpy(), want.numpy()) <= 1e-10

    @pytest.mark.parametrize("window", [1, 5, aw_fused.WINDOW])
    @pytest.mark.parametrize("crowd", [False, True])
    def test_plan_matches_brute_force(self, window, crowd):
        """Stable order, every valid record in exactly one item, the
        invalid ones in none, no item longer than a window; ``crowd`` puts
        a third of the records on one pair."""
        rng = np.random.default_rng(window)
        pr = problem(rng, 700, nant=5, lim=0.6)
        if crowd:
            pr.a1[::3] = pr.a2[::3] = 2
        shape = (120, 150)
        rec, pt, _, _ = _records_tables(pr, shape, remap=True)
        npair = pt.shape[0]
        order, items = aw_fused.aw_pair_plan(rec, shape, npair, window)
        want_order, want_items = _brute_pair_plan(rec, shape, npair, window)
        n_valid = len(want_order)
        assert 0 < n_valid < 700
        np.testing.assert_array_equal(order[:n_valid].numpy(), want_order)
        assert set(order[n_valid:].tolist()) == set(
            np.flatnonzero(~rec.valid.numpy()).tolist())
        assert items.dtype == torch.int32
        assert [tuple(c) for c in items.T.tolist()] == want_items
        covered = np.concatenate([np.arange(f, e) for _, f, e in want_items])
        np.testing.assert_array_equal(covered, np.arange(n_valid))
        if crowd:
            assert max(e - f for _, f, e in want_items) == window

    @pytest.mark.parametrize("s", [7, 15])
    def test_plan_order_accumulation_matches_plain(self, s):
        """The kernel's arithmetic in plan order (pair row from the item,
        FFT-shaped sandwich, conjugate, visibility) gives the plain grid."""
        rng = np.random.default_rng(30 + s)
        pr = problem(rng, 3000, nant=8, s=s, lim=0.53)
        shape = (512, 512)
        rec, pt, ws, vis = _records_tables(pr, shape, remap=True)
        order, items = aw_fused.aw_pair_plan(rec, shape, pt.shape[0])
        got = torch.zeros(shape, dtype=vis.dtype)
        for pair, first, end in items.T.tolist():
            b = order[first:end]
            Z = aw_fused.synthesis_fft(
                pt[pair] * ws[rec.kidx[b].long()], s)
            y, x = torch.broadcast_tensors(
                rec.y0[b, None, None] + torch.arange(s)[:, None],
                rec.x0[b, None, None] + torch.arange(s))
            inb = (y >= 0) & (y < shape[0]) & (x >= 0) & (x < shape[1])
            got.index_put_((y[inb], x[inb]),
                           (vis[b, None, None] * Z.conj())[inb],
                           accumulate=True)
        want = aw_fused.aw_fused_plain(pt, ws, rec, vis, shape)
        assert _rel(got.numpy(), want.numpy()) <= 1e-12


class TestPallasFold:
    """``aw_fused_plain`` against each TPU kernel the CUDA kernel stands
    for, in interpret mode at the ``exact`` tier."""

    @pytest.mark.parametrize("kernel", ["resident", "tiled", "slab"])
    @pytest.mark.parametrize("s,qpx,nant,nw", [(15, 4, 6, 3), (7, 2, 4, 2)])
    def test_plain_matches_pallas(self, j, monkeypatch, kernel, s, qpx,
                                  nant, nw):
        monkeypatch.setenv("SKA_SDP_TPU_AW_PRECISION", "exact")
        rng = np.random.default_rng(11 + s)
        pr = problem(rng, 300, nant=nant, nw=nw, qpx=qpx, s=s,
                     dtype=np.complex64)
        shape = (256, 256)
        fn = {"resident": j.resident.convgrid_aw_resident,
              "tiled": j.tiled.convgrid_aw_fused,
              "slab": j.slab.convgrid_aw_pallas}[kernel]
        kw = {"slab": 128} if kernel == "slab" else {}
        J = j.jnp.asarray
        want = np.asarray(fn(J(pr.wk), J(pr.ak),
                             j.jnp.zeros(shape, j.jnp.complex64), J(pr.p),
                             J(pr.wbin), J(pr.a1), J(pr.a2), J(pr.vis),
                             interpret=True, **kw))
        rec, pt, ws, vis = _records_tables(pr, shape, remap=True)
        got = aw_fused.aw_fused_plain(pt, ws, rec, vis, shape)
        assert _rel(got.numpy(), want) <= CUDA_TOL

    def test_wrapper_checks(self):
        pr = problem(np.random.default_rng(12), 8, dtype=np.complex64)
        rec, pt, ws, vis = _records_tables(pr, (64, 64))
        grid = torch.zeros((64, 64), dtype=torch.complex64)
        aw_fused._check(pt, ws, rec, vis, grid)
        with pytest.raises(ValueError, match="one device"):
            aw_fused._check(pt.to("meta"), ws, rec, vis, grid)
        with pytest.raises(ValueError, match="complex64"):
            aw_fused._check(pt.to(torch.complex128), ws, rec, vis, grid)
        with pytest.raises(ValueError, match="rows, 32, 32"):
            aw_fused._check(pt[..., :8], ws, rec, vis, grid)
        with pytest.raises(ValueError, match="support 7"):
            aw_fused._check(pt, ws, rec._replace(support=7), vis, grid)
        with pytest.raises(NotImplementedError, match="s ≤ 32"):
            aw_fused._check(pt, ws, rec._replace(support=33), vis, grid)
        aw_fused._launches[aw_fused.GRID_KERNEL] = 3
        aw_fused.reset_launch_count()
        assert aw_fused.launch_count() == 0


# ---------------------------------------------------------------------------
# The imaging program, the entries and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def observation():
    cfg = synthetic.SyntheticConfig(theta=THETA, lam=LAM, nant=10, ntime=12,
                                    nw_planes=8, qpx=4)
    obs = synthetic.simulate_observation(cfg)
    centers = synthetic.w_plane_centers(obs, cfg)
    bank = np.stack([synthetic.w_kernel_host(THETA, float(w), 4, 256, 15)
                     for w in centers])
    ak = synthetic.akern_stamps(cfg)[:, 0, 0]
    return SimpleNamespace(obs=obs, vd=ds.vis_data_from_observation(obs),
                           bank=bank, centers=centers, ak=ak)


class TestAWPipeline:
    @pytest.mark.parametrize("precision,tol", [("double", 1e-8),
                                               ("single", 1e-4)])
    def test_matches_jax_pipeline(self, j, observation, precision, tol):
        o = observation
        vd = o.vd
        cdt, rdt = ((np.complex128, np.float64) if precision == "double"
                    else (np.complex64, np.float32))
        args = (o.bank.astype(cdt), o.centers.astype(rdt), o.ak.astype(cdt),
                vd.uvw.astype(rdt), vd.antenna1.astype(np.int32),
                vd.antenna2.astype(np.int32), vd.time.astype(rdt),
                np.asarray(vd.frequency, rdt), vd.vis.astype(cdt))
        want, want_max = j.ds._aw_pipeline(*args, theta=THETA, lam=LAM,
                                           chunk=256)
        # the port's pipeline takes no times: only the antennas are read
        t_args = args[:6] + args[7:]
        got, got_max = ds._aw_pipeline(*map(torch.as_tensor, t_args),
                                       theta=THETA, lam=LAM, chunk=256)
        want = np.asarray(want)
        assert got.shape == want.shape == (N, N)
        assert got.dtype == (torch.float64 if precision == "double"
                             else torch.float32)
        assert _rel(got.numpy(), want) <= tol
        assert abs(float(got_max) - float(want_max)) <= tol * abs(
            float(want_max))

    def test_entry_peaks_at_a_source(self, observation):
        o = observation
        res = ds.aw_image(o.vd, o.bank, o.centers, o.ak, theta=THETA,
                          lam=LAM, device="cpu")
        img = res.image.numpy()
        assert img.shape == (N, N) and np.isfinite(img).all()
        assert res.image_max == float(img.max())
        iy, ix = np.unravel_index(np.argmax(img), img.shape)
        d = min(abs(iy - (N / 2 + m * LAM)) + abs(ix - (N / 2 + l * LAM))
                for l, m, _ in o.obs["sources"])
        assert d <= 3.0
        # n caps the record count
        part = ds.aw_image(o.vd, o.bank, o.centers, o.ak, theta=THETA,
                           lam=LAM, n=100, device="cpu")
        assert part.image_max != res.image_max


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("awf") / "obs")
    assert cli.main(["--make-data", d, "--nant", "8", "--ntime", "6",
                     "--nw", "8", "--qpx", "4", *GEO]) == 0
    return d


class TestCLI:
    def test_default_mode_is_the_references(self, j):
        assert cli.build_parser().parse_args([]).mode == "aw"
        assert (cli.build_parser().parse_args([]).mode
                == j.cli.build_parser().parse_args([]).mode)
        assert cli.build_parser().parse_args(["-old"]).old

    def test_parser_takes_every_reference_flag(self, j):
        ours = set(cli.build_parser()._option_string_actions)
        theirs = set(j.cli.build_parser()._option_string_actions)
        assert theirs <= ours, sorted(theirs - ours)

    def test_fused_aw_matches_jax_cli(self, j, data_dir, tmp_path, capsys):
        out = {}
        for name, argv in (
                ("t", [cli.main, "--mode", "aw", "--device", "cpu"]),
                ("t_default", [cli.main, "--device", "cpu", "-old"]),
                ("j", [j.cli.main, "--mode", "aw", "--backend", "cpu"])):
            main, *flags = argv
            img = str(tmp_path / f"{name}.h5")
            assert main([*flags, "-i", data_dir, "--all", "-o", img,
                         *GEO]) == 0
            assert "image max: " in capsys.readouterr().out
            out[name] = h5.read_dataset(img, "/img")
        assert out["t"].shape == (N, N) and out["t"].dtype == np.float64
        assert _rel(_crop(out["t"]), _crop(out["j"])) <= 1e-4
        np.testing.assert_array_equal(out["t_default"], out["t"])

    def test_missing_wkern_is_reported(self, data_dir, tmp_path, capsys):
        for f in ("vis.h5", "akern.h5"):
            os.symlink(os.path.join(data_dir, f), str(tmp_path / f))
        assert cli.main(["-i", str(tmp_path), "--all", "--device", "cpu",
                         *GEO]) == 1
        err = capsys.readouterr().err
        assert f"input file not found: {tmp_path / 'wkern.h5'}" in err


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
class TestCudaKernel:
    @pytest.mark.parametrize("s", [2, 4, 7, 15, 32])
    def test_kernel_matches_plain_on_card(self, cuda_device, s):
        """Shape (a) of the chip smoke test: 512², 16 antennas, nw = 4,
        qpx = 4, random bank and A-kernels, records past the edges; every
        m of the envelope but m = 1."""
        rng = np.random.default_rng(20 + s)
        pr = problem(rng, 20000, nant=16, nw=4, qpx=4, s=s,
                     dtype=np.complex64)
        self._card_parity(pr, cuda_device)

    def test_one_pair_with_thousands_of_records_on_card(self, cuda_device):
        """Half the records on one pair: its run is cut into many work
        items that stage the same pair row."""
        rng = np.random.default_rng(34)
        pr = problem(rng, 20000, nant=16, nw=4, qpx=4, s=15,
                     dtype=np.complex64)
        pr.a1[::2], pr.a2[::2] = 3, 5
        self._card_parity(pr, cuda_device)

    @staticmethod
    def _card_parity(pr, cuda_device):
        shape = (512, 512)
        rec, pt, ws, vis = _records_tables(pr, shape, cuda_device,
                                           remap=True)
        aw_fused.reset_launch_count()
        placed = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        got = aw_fused.aw_fused_grid(pt, ws, rec, vis, shape,
                                     n_valid=placed)
        torch.cuda.synchronize()
        assert aw_fused.launch_count() == 1
        assert 0 < int(placed) == int(rec.valid.sum()) < 20000
        want = aw_fused.aw_fused_plain(pt, ws, rec, vis, shape)
        assert _rel(got.cpu().numpy(), want.cpu().numpy()) < CUDA_TOL
        # the dispatch on the card: the same grid from the raw kernels
        wk, ak, p, wbin, a1, a2, _ = _t(pr, cuda_device)
        via = kernels.aw_gridder(wk, ak, torch.zeros_like(got), p, wbin,
                                 a1, a2, vis)
        assert _rel(via.cpu().numpy(), want.cpu().numpy()) < CUDA_TOL

    def test_support_beyond_the_envelope_raises_on_card(self, cuda_device):
        pr = problem(np.random.default_rng(31), 10, nant=2, nw=1, qpx=1,
                     s=33, dtype=np.complex64)
        wk, ak, p, wbin, a1, a2, vis = _t(pr, cuda_device)
        with pytest.raises(NotImplementedError, match="s ≤ 32"):
            kernels.aw_gridder(wk, ak, torch.zeros((64, 64), dtype=vis.dtype,
                                                   device=cuda_device),
                               p, wbin, a1, a2, vis)

    def test_double_raises_on_card(self, cuda_device):
        pr = problem(np.random.default_rng(30), 10)
        wk, ak, p, wbin, a1, a2, vis = _t(pr, cuda_device)
        with pytest.raises(ValueError, match="complex64"):
            kernels.aw_gridder(wk, ak, torch.zeros((64, 64), dtype=vis.dtype,
                                                   device=cuda_device),
                               p, wbin, a1, a2, vis)
