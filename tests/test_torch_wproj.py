"""Port parity for the bank w-projection kernels and the modules under them.

Inputs come from numpy with a seed and go to both packages; the JAX side
runs as its own tests run it on the CPU (x64, Pallas ``interpret=True``).
Bounds:

* exact: ``find_closest``; ``frac_coords`` cells and fractions at cell and
  half-cell boundaries; the records' ``valid``, placements and ``kidx``;
* 1e-10 (float64): the w-kernel bank; the plain scatter and gather against
  JAX ``convgrid_wproj`` and ``degrid_wproj``; the adjoint identity
  ``<G, grid(v)> = <degrid(G), v>`` with the same bank on both sides (the
  gather conjugates it);
* exact: the scatter's tile binning against a numpy enumeration of each
  record's in-grid cells; 1e-12 (complex128): a plain accumulation in tile
  order against ``convgrid_wproj``;
* exact: the gather's plan (a permutation of the records by the tile of
  their clamped origin, the invalid last); 1e-12 (complex128): a gather
  through the plan from each tile's staged region, written back to input
  indices, against ``degrid_wproj``;
* atol 2e-4, rtol 1e-4 (float32, the JAX tests' own bound): the plain
  versions against the resident and the tiled Pallas kernels, including
  out-of-bounds edge records and odd and non-square grids.  The tiled
  kernels fold into the same CUDA kernels, so agreeing with both is the CPU
  half of the fold's evidence.

On the CPU the wrappers take the plain versions; the CUDA kernels are held
to them by the ``cuda``-marked tests (rel-L2 ≤ 5e-5: float32 sums taken in
atomic order), which skip without a card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch import kernels
from ska_sdp_tpu_torch.config import KernelOptions
from ska_sdp_tpu_torch.kernels import wproj
from ska_sdp_tpu_torch.ops import frac_coords
from ska_sdp_tpu_torch.ops.gridding import convgrid_wproj, degrid_wproj
from ska_sdp_tpu_torch.ops.search import find_closest
from ska_sdp_tpu_torch.ops.wkernel import (extract_oversampled, w_kernel,
                                           w_kernel_bank)

torch.set_num_threads(2)

TOL_F32 = dict(atol=2e-4, rtol=1e-4)
CUDA_TOL = 5e-5


@pytest.fixture(scope="module")
def j():
    """The JAX reference, imported only by the tests that compare with it,
    so the ``cuda`` tests also run where jax is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from ska_sdp_tpu import config, ops
    from ska_sdp_tpu.kernels import wproj_degrid_pallas as degrid_tiled
    from ska_sdp_tpu.kernels import wproj_degrid_resident_pallas as degrid_res
    from ska_sdp_tpu.kernels import wproj_pallas as grid_tiled
    from ska_sdp_tpu.kernels import wproj_resident_pallas as grid_res
    from ska_sdp_tpu.ops import wkernel

    return SimpleNamespace(jnp=jnp, ops=ops, config=config, wkernel=wkernel,
                           grid_res=grid_res, grid_tiled=grid_tiled,
                           degrid_res=degrid_res, degrid_tiled=degrid_tiled)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cplx(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def problem(rng, b=300, nw=2, qpx=4, s=15, lo=-0.49, hi=0.49, edge=False,
            dtype=np.complex128):
    """A random bank, records and visibilities; ``edge`` puts the records
    near and beyond the grid's edge (partial and fully outside patches)."""
    rdt = np.float64 if dtype == np.complex128 else np.float32
    if edge:
        p = rng.uniform(0.47, 0.60, (b, 3))
        p[::2] *= -1
    else:
        p = rng.uniform(lo, hi, (b, 3))
    return SimpleNamespace(bank=_cplx(rng, (nw, qpx, qpx, s, s), dtype),
                           p=p.astype(rdt),
                           wbin=rng.integers(0, nw, b).astype(np.int32),
                           vis=_cplx(rng, b, dtype))


def _t(x, device="cpu"):
    return torch.as_tensor(x, device=device)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


class TestFindClosest:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_matches_jax(self, j, dtype):
        rng = np.random.default_rng(1)
        centers = np.sort(rng.uniform(-4000, 4000, 32)).astype(dtype)
        # inside, outside the centre range, on the centres, at midpoints
        x = np.concatenate([rng.uniform(-5000, 5000, 500), centers,
                            (centers[1:] + centers[:-1]) / 2,
                            [-1e9, 1e9]]).astype(dtype)
        want = np.asarray(j.ops.find_closest(j.jnp.asarray(centers),
                                             j.jnp.asarray(x)))
        got = find_closest(_t(centers), _t(x))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_exact_ties_go_to_the_higher_index(self, j, dtype):
        centers = np.array([-3.0, -1.0, 0.0, 2.0, 6.0], dtype)
        x = np.array([-2.0, -0.5, 1.0, 4.0, -9.0, 9.0], dtype)
        got = find_closest(_t(centers), _t(x)).numpy()
        np.testing.assert_array_equal(got, [1, 2, 3, 4, 0, 4])
        want = j.ops.find_closest(j.jnp.asarray(centers), j.jnp.asarray(x))
        np.testing.assert_array_equal(got, np.asarray(want))

    def test_single_centre(self, j):
        x = np.array([-5.0, 0.0, 7.0])
        got = find_closest(_t(np.array([1.0])), _t(x)).numpy()
        want = j.ops.find_closest(j.jnp.asarray([1.0]), j.jnp.asarray(x))
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, [0, 0, 0])


class TestFracCoords:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("shape,qpx", [((256, 256), 8), ((255, 383), 4),
                                           ((180, 180), 1)])
    def test_matches_jax_at_boundaries(self, j, dtype, shape, qpx):
        """Cells and fractions are the kernels' addresses: exact equality
        at cell edges, half cells and the fraction rounding points, and
        one ulp either side of each."""
        H, W = shape
        ks = np.arange(-6, 7)
        pts = []
        for n in (H, W):
            for off in (0.0, 0.5, -0.5 / qpx, 0.5 / qpx, 0.25):
                pts.append((ks + off) / n)
        base = np.concatenate(pts + [np.array([-0.5, 0.5, 0.4999])])
        base = base.astype(dtype)
        vals = np.concatenate([base, np.nextafter(base, dtype(1)),
                               np.nextafter(base, dtype(-1))])
        p = np.stack([vals, vals[::-1], vals], 1).astype(dtype)
        want = j.ops.frac_coords((H, W), qpx, j.jnp.asarray(p))
        got = frac_coords((H, W), qpx, _t(p))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


class TestWKernel:
    @pytest.mark.parametrize("opts", [
        dict(qpx=4, npix_ff=64, npix_kern=15),
        dict(qpx=3, npix_ff=50, npix_kern=9),
    ])
    def test_bank_matches_jax(self, j, opts):
        theta = 0.05
        centers = np.linspace(-300.0, 300.0, 5)
        want = np.asarray(j.wkernel.w_kernel_bank(
            theta, j.jnp.asarray(centers), j.config.KernelOptions(**opts)))
        got = w_kernel_bank(theta, _t(centers), KernelOptions(**opts))
        assert got.shape == want.shape == (5, opts["qpx"], opts["qpx"],
                                           opts["npix_kern"],
                                           opts["npix_kern"])
        assert got.dtype == torch.complex128
        assert _rel(got.numpy(), want) < 1e-10

    def test_scalar_w_and_extraction(self, j):
        opts = KernelOptions(qpx=4, npix_ff=32, npix_kern=7)
        got = w_kernel(0.05, 120.0, opts)
        assert got.shape == (4, 4, 7, 7)
        want = np.asarray(j.wkernel.w_kernel(
            0.05, 120.0, j.config.KernelOptions(qpx=4, npix_ff=32,
                                                npix_kern=7)))
        assert _rel(got.numpy(), want) < 1e-10
        a = _cplx(np.random.default_rng(2), (2, 60, 60))
        np.testing.assert_array_equal(
            extract_oversampled(_t(a), 3, 9).numpy(),
            np.asarray(j.wkernel.extract_oversampled(j.jnp.asarray(a), 3,
                                                     9)))


class TestRecords:
    @pytest.mark.parametrize("shape,edge", [((256, 256), True),
                                            ((301, 301), False),
                                            ((255, 383), False)])
    def test_match_jax_resident_records(self, j, shape, edge):
        """``valid``, the placements and ``kidx`` equal the TPU records'
        (which store ``y0 + PAD`` and ``x0 + PAD`` for valid records)."""
        rng = np.random.default_rng(3)
        nw, qpx, s = 4, 8, 15
        pr = problem(rng, 2000, nw, qpx, s, edge=edge, dtype=np.complex64)
        jr, jvalid = j.grid_res.wproj_resident_records(
            shape, qpx, s, s, j.jnp.asarray(pr.p), j.jnp.asarray(pr.wbin),
            j.jnp.zeros(2000), j.jnp.zeros(2000), return_valid=True)
        jr = np.asarray(jr).transpose(1, 0, 2).reshape(8, -1)[:, :2000]
        jvalid = np.asarray(jvalid)
        y0, x0, kidx, valid = wproj.wproj_records(
            shape, qpx, s, s, nw * qpx * qpx, _t(pr.p), _t(pr.wbin))
        np.testing.assert_array_equal(valid.numpy(), jvalid)
        assert 0 < jvalid.sum() and (edge or jvalid.all())
        pad = j.grid_res.PAD
        v = jvalid
        np.testing.assert_array_equal(y0.numpy()[v] + pad, jr[0][v])
        np.testing.assert_array_equal(x0.numpy()[v] + pad, jr[1][v])
        np.testing.assert_array_equal(kidx.numpy(), jr[2].astype(np.int64))
        assert kidx.dtype == y0.dtype == torch.int32


class TestPlainVsJax:
    @pytest.mark.parametrize("shape,edge,chunk", [((40, 40), False, 8),
                                                  ((255, 383), False, 128),
                                                  ((256, 256), True, 16)])
    def test_scatter_matches_convgrid_wproj(self, j, shape, edge, chunk):
        pr = problem(np.random.default_rng(4), 300, edge=edge)
        want = np.asarray(j.ops.convgrid_wproj(
            j.jnp.asarray(pr.bank), j.jnp.zeros(shape, j.jnp.complex128),
            j.jnp.asarray(pr.p), j.jnp.asarray(pr.wbin),
            j.jnp.asarray(pr.vis), chunk=chunk))
        got = convgrid_wproj(_t(pr.bank), torch.zeros(shape,
                                                      dtype=torch.complex128),
                             _t(pr.p), _t(pr.wbin), _t(pr.vis), chunk=chunk)
        assert got.dtype == torch.complex128
        assert _rel(got.numpy(), want) < 1e-10

    @pytest.mark.parametrize("shape,edge,chunk", [((40, 40), False, 8),
                                                  ((301, 211), False, 128),
                                                  ((256, 256), True, 16)])
    def test_gather_matches_degrid_wproj(self, j, shape, edge, chunk):
        rng = np.random.default_rng(5)
        pr = problem(rng, 300, edge=edge)
        G = _cplx(rng, shape)
        want = np.asarray(j.ops.degrid_wproj(
            j.jnp.asarray(pr.bank), j.jnp.asarray(G), j.jnp.asarray(pr.p),
            j.jnp.asarray(pr.wbin), chunk=chunk))
        got = degrid_wproj(_t(pr.bank), _t(G), _t(pr.p), _t(pr.wbin),
                           chunk=chunk).numpy()
        assert _rel(got, want) < 1e-10
        if edge:   # records with no cell inside predict exactly 0
            _, _, _, valid = wproj.wproj_records(
                shape, 4, 15, 15, 32, _t(pr.p), _t(pr.wbin))
            assert (~valid).any()
            assert np.all(got[~valid.numpy()] == 0)

    @pytest.mark.parametrize("shape", [(40, 40), (97, 130), (256, 256)])
    def test_adjoint_dot_product(self, shape):
        rng = np.random.default_rng(6)
        pr = problem(rng, 200, nw=3, qpx=2, s=7, lo=-0.55, hi=0.55)
        G = _cplx(rng, shape)
        Av = kernels.wproj_gridder(_t(pr.bank), shape, _t(pr.p),
                                   _t(pr.wbin), _t(pr.vis), chunk=16)
        AtG = kernels.wproj_degridder(_t(pr.bank), _t(G), _t(pr.p),
                                      _t(pr.wbin), chunk=16)
        lhs = np.vdot(G, Av.numpy())
        rhs = np.vdot(AtG.numpy(), pr.vis)
        assert abs(lhs - rhs) <= 1e-10 * abs(lhs)

    def test_init_accumulates_and_stays_unchanged(self):
        pr = problem(np.random.default_rng(7), 100)
        init = _t(_cplx(np.random.default_rng(8), (64, 64)))
        before = init.clone()
        args = (_t(pr.bank), (64, 64), _t(pr.p), _t(pr.wbin), _t(pr.vis))
        got = kernels.wproj_gridder(*args, init=init)
        torch.testing.assert_close(got, before + kernels.wproj_gridder(*args),
                                   rtol=1e-12, atol=1e-12)
        assert torch.equal(init, before)


def _bank(rng, gh, gw, nw=2, qpx=4, dtype=np.complex128):
    return _cplx(rng, (nw, qpx, qpx, gh, gw), dtype)


class TestTilePlan:
    """The tile binning and the tile-order sum of ``csrc/wproj_grid.cu``,
    on the CPU."""

    @pytest.mark.parametrize("shape,gh,gw,edge", [
        ((256, 256), 15, 15, True), ((100, 70), 7, 9, False),
        ((130, 97), 40, 35, True), ((64, 64), 1, 1, True)])
    def test_binning_matches_cell_enumeration(self, shape, gh, gw, edge):
        """Each valid record sits in exactly the tiles that hold its
        in-grid cells (so their union is its cells), once each, in input
        order within a tile, no item above the cap; the invalid records
        in none."""
        H, W = shape
        T = wproj.TILE
        rng = np.random.default_rng(gh * gw)
        pr = problem(rng, 400, qpx=4, edge=edge)
        y0, x0, _, valid = wproj.wproj_records(shape, 4, gh, gw, 32,
                                               _t(pr.p), _t(pr.wbin))
        window = 7
        entries, items, ntx = wproj.wproj_tile_plan(y0, x0, gh, gw, shape,
                                                    window)
        assert ntx == -(-W // T) and entries.dtype == torch.int32
        slots = ((gh + T - 2) // T + 1) * ((gw + T - 2) // T + 1)
        assert entries.shape == (400 * slots,)
        got = {}
        for tile, first, end in items.T.tolist():
            assert 0 < end - first <= window
            assert first // window == (end - 1) // window
            got.setdefault(tile, []).extend(entries[first:end].tolist())
        want = {}
        y0, x0 = y0.numpy(), x0.numpy()
        for r in np.flatnonzero(valid.numpy()):
            ys = np.arange(y0[r], y0[r] + gh)
            xs = np.arange(x0[r], x0[r] + gw)
            ys, xs = ys[(ys >= 0) & (ys < H)], xs[(xs >= 0) & (xs < W)]
            assert ys.size and xs.size
            for t in np.unique((ys[:, None] // T) * ntx + xs[None] // T):
                want.setdefault(int(t), []).append(int(r))
        assert got == want and valid.any()
        if edge and gh < 20:   # records wholly past the edges are in none
            assert (~valid).any()

    @pytest.mark.parametrize("gh,gw", [(15, 15), (7, 9), (40, 35)])
    def test_tile_order_accumulation_matches_plain(self, gh, gw):
        """Each tile's sum of its entries' cells, added to the grid once,
        gives ``convgrid_wproj``'s grid."""
        shape = (512, 512)
        rng = np.random.default_rng(50 + gh)
        pr = problem(rng, 3000, edge=False, lo=-0.53, hi=0.53)
        bank = _t(_bank(rng, gh, gw))
        p, wbin, vis = _t(pr.p), _t(pr.wbin), _t(pr.vis)
        y0, x0, kidx, _ = wproj.wproj_records(shape, 4, gh, gw, 32, p, wbin)
        entries, items, ntx = wproj.wproj_tile_plan(y0, x0, gh, gw, shape,
                                                    64)
        T = wproj.TILE
        taps = bank.reshape(32, gh, gw)
        got = torch.zeros(shape, dtype=torch.complex128)
        for tile, first, end in items.T.tolist():
            acc = torch.zeros((T, T), dtype=torch.complex128)
            ty, tx = (tile // ntx) * T, (tile % ntx) * T
            for r in entries[first:end].tolist():
                ys = torch.arange(gh) + y0[r]
                xs = torch.arange(gw) + x0[r]
                iy = (ys >= ty) & (ys < min(ty + T, shape[0]))
                ix = (xs >= tx) & (xs < min(tx + T, shape[1]))
                acc[(ys[iy] - ty)[:, None], (xs[ix] - tx)[None]] += (
                    vis[r] * taps[kidx[r]][iy][:, ix])
            h, w = min(T, shape[0] - ty), min(T, shape[1] - tx)
            got[ty:ty + h, tx:tx + w] += acc[:h, :w]
        want = convgrid_wproj(bank, torch.zeros(shape,
                                                dtype=torch.complex128),
                              p, wbin, vis)
        assert _rel(got.numpy(), want.numpy()) <= 1e-12


class TestGatherPlan:
    """The records' order and the tile regions of ``csrc/wproj_degrid.cu``,
    on the CPU."""

    CASES = [((256, 256), 15, 15, True), ((100, 70), 7, 9, False),
             ((130, 97), 32, 32, True), ((211, 640), 15, 15, True)]

    @staticmethod
    def _plan(shape, gh, gw, edge, seed, n=600, window=64):
        rng = np.random.default_rng(seed)
        pr = problem(rng, n, qpx=4, edge=edge)
        if edge:    # beyond every edge: the corners and both sides of each
            pr.p[::3, :2] *= -1
        y0, x0, kidx, valid = wproj.wproj_records(shape, 4, gh, gw, 32,
                                                  _t(pr.p), _t(pr.wbin))
        order, items, ntx = wproj.wproj_gather_plan(y0, x0, gh, gw, shape,
                                                    window)
        return rng, pr, (y0, x0, kidx, valid), order, items, ntx

    @pytest.mark.parametrize("shape,gh,gw,edge", CASES)
    def test_order_is_a_tile_sorted_permutation(self, shape, gh, gw, edge):
        """Every record once; keys (the tile of the origin clamped to the
        grid) non-decreasing; input order within a tile; the invalid
        records last; the items cover the valid positions inside aligned
        windows."""
        H, W = shape
        T = wproj.TILE
        _, _, (y0, x0, _, valid), order, items, ntx = self._plan(
            shape, gh, gw, edge, seed=gh + gw + H)
        n = y0.shape[0]
        assert ntx == -(-W // T)
        assert torch.equal(torch.sort(order).values, torch.arange(n))
        ntiles = -(-H // T) * ntx
        key = torch.where(valid, (y0.clamp(min=0) // T) * ntx
                          + x0.clamp(min=0) // T, ntiles)[order]
        assert bool((key[1:] >= key[:-1]).all())
        same = key[1:] == key[:-1]
        assert bool((order[1:][same] > order[:-1][same]).all())
        n_valid = int(valid.sum())
        assert bool(valid[order[:n_valid]].all())
        assert not bool(valid[order[n_valid:]].any())
        if edge and gh < 20:   # records wholly past the edges are in none
            assert 0 < n_valid < n
        covered = torch.zeros(n, dtype=torch.int64)
        for tile, first, end in items.T.tolist():
            assert first // 64 == (end - 1) // 64
            assert bool((key[first:end] == tile).all())
            covered[first:end] += 1
        assert torch.equal(covered, (torch.arange(n) < n_valid).long())

    @pytest.mark.parametrize("shape,gh,gw,edge", CASES)
    def test_gather_through_the_plan_matches_plain(self, shape, gh, gw,
                                                   edge):
        """Each item's records gathered from its tile's (T + gh − 1) ×
        (T + gw − 1) region, zero beyond the grid and below row and column
        0, and written back to their input indices, give
        ``degrid_wproj``."""
        H, W = shape
        T = wproj.TILE
        rng, pr, (y0, x0, kidx, _), order, items, ntx = self._plan(
            shape, gh, gw, edge, seed=7 * gh + gw)
        bank = _t(_bank(rng, gh, gw))
        G = _t(_cplx(rng, shape))
        taps = bank.reshape(32, gh, gw)
        got = torch.zeros(y0.shape[0], dtype=torch.complex128)
        pad = torch.zeros((H + T + gh, W + T + gw), dtype=torch.complex128)
        pad[:H, :W] = G
        for tile, first, end in items.T.tolist():
            R0, C0 = (tile // ntx) * T, (tile % ntx) * T
            region = pad[R0:R0 + T + gh - 1, C0:C0 + T + gw - 1]
            for r in order[first:end].tolist():
                ry, rx = int(y0[r]) - R0, int(x0[r]) - C0
                rows = torch.arange(gh) + ry
                cols = torch.arange(gw) + rx
                cells = region[rows.clamp(min=0)[:, None],
                               cols.clamp(min=0)[None, :]]
                cells = cells * ((rows >= 0)[:, None] & (cols >= 0)[None, :])
                got[r] = torch.sum(cells * torch.conj(taps[kidx[r]]))
        want = degrid_wproj(bank, G, _t(pr.p), _t(pr.wbin))
        assert _rel(got.numpy(), want.numpy()) <= 1e-12


class TestPallasInterpret:
    """The port's plain versions against the reference's TPU kernels in
    interpret mode, float32."""

    @pytest.mark.parametrize("kernel,shape,edge", [
        ("resident", (300, 300), False),
        ("resident", (256, 256), True),
        ("resident", (211, 640), False),
        ("tiled", (300, 500), False),
        ("tiled", (256, 256), True),
    ])
    def test_scatter(self, j, kernel, shape, edge):
        pr = problem(np.random.default_rng(9), 300, nw=2, qpx=4,
                     edge=edge, dtype=np.complex64)
        fn = (j.grid_res.wproj_gridder_resident if kernel == "resident"
              else j.grid_tiled.wproj_gridder_pallas)
        want = np.asarray(fn(j.jnp.asarray(pr.bank), shape,
                             j.jnp.asarray(pr.p), j.jnp.asarray(pr.wbin),
                             j.jnp.asarray(pr.vis), interpret=True))
        got = kernels.wproj_gridder(_t(pr.bank), shape, _t(pr.p),
                                    _t(pr.wbin), _t(pr.vis))
        assert got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), want, **TOL_F32)

    @pytest.mark.parametrize("kernel,shape,edge", [
        ("resident", (301, 301), False),
        ("resident", (256, 256), True),
        ("tiled", (255, 383), False),
    ])
    def test_gather(self, j, kernel, shape, edge):
        rng = np.random.default_rng(10)
        pr = problem(rng, 300, nw=2, qpx=4, edge=edge, dtype=np.complex64)
        G = _cplx(rng, shape, np.complex64)
        fn = (j.degrid_res.wproj_degridder_resident if kernel == "resident"
              else j.degrid_tiled.wproj_degridder_pallas)
        want = np.asarray(fn(j.jnp.asarray(pr.bank), j.jnp.asarray(G),
                             j.jnp.asarray(pr.p), j.jnp.asarray(pr.wbin),
                             interpret=True))
        got = kernels.wproj_degridder(_t(pr.bank), _t(G), _t(pr.p),
                                      _t(pr.wbin))
        np.testing.assert_allclose(got.numpy(), want, **TOL_F32)


class TestWrappers:
    def test_kernel_input_checks(self):
        bank = torch.zeros((2, 4, 4, 15, 15), dtype=torch.complex128)
        grid = torch.zeros((64, 64), dtype=torch.complex64)
        p, wbin = torch.zeros((8, 3)), torch.zeros(8, dtype=torch.int32)
        with pytest.raises(ValueError, match="precision 'double'"):
            wproj._check(bank, grid, p, wbin)
        with pytest.raises(ValueError, match=r"\[nw, qpx, qpx, gh, gw\]"):
            wproj._check(bank.to(torch.complex64)[0], grid, p, wbin)

    @pytest.mark.parametrize("stray", ["p", "wbin"])
    def test_records_must_lie_on_the_kernel_device(self, stray):
        """A record array on another device than the bank would hand the
        kernel a pointer it cannot read; the check refuses it first."""
        bank = torch.zeros((2, 4, 4, 15, 15), dtype=torch.complex64)
        grid = torch.zeros((64, 64), dtype=torch.complex64)
        rec = dict(p=torch.zeros((8, 3)),
                   wbin=torch.zeros(8, dtype=torch.int32))
        wproj._check(bank, grid, **rec)
        rec[stray] = rec[stray].to("meta")
        with pytest.raises(ValueError, match="one device"):
            wproj._check(bank, grid, **rec)

    def test_build_digest_covers_the_headers(self, tmp_path, monkeypatch):
        """A kernel's library is named by its source and every header in
        ``csrc/``, so an edited header rebuilds the kernels."""
        from ska_sdp_tpu_torch.kernels import _build

        (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
        (tmp_path / "h.cuh").write_text("// one\n")
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        first = _build.source_digest("k")
        assert _build.source_digest("k") == first
        (tmp_path / "h.cuh").write_text("// two\n")
        assert _build.source_digest("k") != first
        (tmp_path / "k.cu").write_text('#include "h.cuh"\n// more\n')
        assert _build.source_digest("k") not in (first,)

    def test_launch_counts_reset(self):
        wproj._launches[wproj.GRID_KERNEL] = 3
        wproj.reset_launch_count()
        assert wproj.launch_count(wproj.GRID_KERNEL) == 0
        assert wproj.launch_count(wproj.DEGRID_KERNEL) == 0


@pytest.mark.cuda
class TestCudaKernels:
    @pytest.mark.parametrize("shape,edge,s", [((512, 512), True, 15),
                                              ((301, 211), False, 15),
                                              ((256, 256), False, 17)])
    def test_kernels_match_plain_on_card(self, cuda_device, shape, edge, s):
        rng = np.random.default_rng(11)
        pr = problem(rng, 20000, nw=4, qpx=4, s=s, edge=edge,
                     dtype=np.complex64)
        G = _t(_cplx(rng, shape, np.complex64), cuda_device)
        args = [_t(x, cuda_device) for x in (pr.bank, pr.p, pr.wbin)]
        vis = _t(pr.vis, cuda_device)
        wproj.reset_launch_count()
        g = kernels.wproj_gridder(args[0], shape, *args[1:], vis)
        v = kernels.wproj_degridder(args[0], G, *args[1:])
        torch.cuda.synchronize()
        assert wproj.launch_count(wproj.GRID_KERNEL) == 1
        assert wproj.launch_count(wproj.DEGRID_KERNEL) == 1
        g_plain = convgrid_wproj(args[0], torch.zeros_like(G), *args[1:],
                                 vis)
        v_plain = degrid_wproj(args[0], G, *args[1:])
        assert _rel(g.cpu().numpy(), g_plain.cpu().numpy()) < CUDA_TOL
        assert _rel(v.cpu().numpy(), v_plain.cpu().numpy()) < CUDA_TOL
        valid = wproj.wproj_records(shape, 4, s, s, 64, args[1],
                                    args[2])[3]
        assert torch.all(v[~valid] == 0)

    @staticmethod
    def _scatter_parity(device, bank, shape, p, wbin, vis):
        args = [_t(x, device) for x in (bank, p, wbin, vis)]
        wproj.reset_launch_count()
        g = kernels.wproj_gridder(args[0], shape, *args[1:])
        torch.cuda.synchronize()
        assert wproj.launch_count(wproj.GRID_KERNEL) == 1
        want = convgrid_wproj(args[0], torch.zeros(
            shape, dtype=torch.complex64, device=device), *args[1:])
        assert _rel(g.cpu().numpy(), want.cpu().numpy()) < CUDA_TOL

    @pytest.mark.parametrize("gh,gw", [(15, 15), (7, 9), (40, 36)])
    def test_scatter_supports_on_card(self, cuda_device, gh, gw):
        """15², a non-square patch and one wider than the scatter's tile,
        with records past the edges."""
        rng = np.random.default_rng(gh + gw)
        pr = problem(rng, 20000, nw=4, qpx=4, lo=-0.55, hi=0.55,
                     dtype=np.complex64)
        bank = _bank(rng, gh, gw, nw=4, qpx=4, dtype=np.complex64)
        self._scatter_parity(cuda_device, bank, (512, 512), pr.p, pr.wbin,
                             pr.vis)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_scatter_at_cell_boundaries_on_card(self, cuda_device, dtype):
        """The scatter places its records itself (``frac_coord`` in p's
        type): at cell edges, half cells and the fraction rounding points,
        and one ulp either side of each, every record lands where the
        plain scatter puts it."""
        H, W, qpx = 255, 383, 4
        ks = np.arange(-6, 7)
        base = np.concatenate([(ks + off) / n for n in (H, W)
                               for off in (0.0, 0.5, -0.5 / qpx, 0.5 / qpx,
                                           0.25)]).astype(dtype)
        vals = np.concatenate([base, np.nextafter(base, dtype(1)),
                               np.nextafter(base, dtype(-1))])
        p = np.stack([vals, vals[::-1], np.zeros_like(vals)], 1)
        rng = np.random.default_rng(15)
        bank = _bank(rng, 7, 7, nw=1, qpx=qpx, dtype=np.complex64)
        self._scatter_parity(cuda_device, bank, (H, W), p,
                             np.zeros(len(vals), np.int32),
                             _cplx(rng, len(vals), np.complex64))

    def test_scatter_one_tile_on_card(self, cuda_device):
        """Every record in one output tile: one tile's run cut into many
        items, their sums added to the same cells."""
        rng = np.random.default_rng(14)
        pr = problem(rng, 20000, nw=4, qpx=4, s=7, lo=8 / 512, hi=20 / 512,
                     dtype=np.complex64)
        shape = (512, 512)
        y0, x0, _, _ = wproj.wproj_records(shape, 4, 7, 7, 64, _t(pr.p),
                                           _t(pr.wbin))
        _, items, _ = wproj.wproj_tile_plan(y0, x0, 7, 7, shape)
        assert len(set(items[0].tolist())) == 1
        assert items.shape[1] == -(-20000 // wproj.WINDOW)
        self._scatter_parity(cuda_device, pr.bank, shape, pr.p, pr.wbin,
                             pr.vis)

    def test_adjoint_on_card(self, cuda_device):
        rng = np.random.default_rng(12)
        pr = problem(rng, 20000, nw=4, qpx=8, dtype=np.complex64)
        G = _t(_cplx(rng, (400, 400), np.complex64), cuda_device)
        args = [_t(x, cuda_device) for x in (pr.bank, pr.p, pr.wbin)]
        vis = _t(pr.vis, cuda_device)
        Av = kernels.wproj_gridder(args[0], (400, 400), *args[1:], vis)
        AtG = kernels.wproj_degridder(args[0], G, *args[1:])
        lhs = torch.vdot(G.reshape(-1), Av.reshape(-1)).item()
        rhs = torch.vdot(AtG, vis).item()
        assert abs(lhs - rhs) <= 1e-5 * abs(lhs)

    def test_double_raises_on_card(self, cuda_device):
        pr = problem(np.random.default_rng(13), 10)
        with pytest.raises(ValueError, match="complex64"):
            kernels.wproj_gridder(_t(pr.bank, cuda_device), (64, 64),
                                  _t(pr.p, cuda_device),
                                  _t(pr.wbin, cuda_device),
                                  _t(pr.vis, cuda_device))

    @staticmethod
    def _gather_parity(device, bank, shape, p, wbin):
        rng = np.random.default_rng(16)
        G = _t(_cplx(rng, shape, np.complex64), device)
        args = [_t(x, device) for x in (bank, p, wbin)]
        wproj.reset_launch_count()
        v = kernels.wproj_degridder(args[0], G, *args[1:])
        torch.cuda.synchronize()
        assert wproj.launch_count(wproj.DEGRID_KERNEL) == 1
        want = degrid_wproj(args[0], G, *args[1:])
        assert _rel(v.cpu().numpy(), want.cpu().numpy()) < CUDA_TOL
        nw, qpx, _, gh, gw = bank.shape
        valid = wproj.wproj_records(shape, qpx, gh, gw, nw * qpx * qpx,
                                    args[1], args[2])[3]
        assert torch.all(v[~valid] == 0) and torch.all(v[valid] != 0)

    @pytest.mark.parametrize("gh,gw", [(7, 7), (15, 15), (32, 32), (7, 32),
                                       (48, 48)])
    def test_gather_supports_on_card(self, cuda_device, gh, gw):
        """The gather's lane mapping and its staged region at each support
        it serves, with records past every edge; 48² takes two column
        segments a row and a region above 48 KB of shared memory."""
        rng = np.random.default_rng(20 + gh + gw)
        pr = problem(rng, 30000, nw=4, qpx=4, lo=-0.55, hi=0.55,
                     dtype=np.complex64)
        bank = _bank(rng, gh, gw, nw=4, qpx=4, dtype=np.complex64)
        self._gather_parity(cuda_device, bank, (301, 211), pr.p, pr.wbin)

    def test_gather_one_tile_on_card(self, cuda_device):
        """262,144 records inside one 32² tile of the gather: one tile's run
        spread over many blocks, each staging the same region."""
        rng = np.random.default_rng(17)
        shape = (512, 512)
        p = np.zeros((1 << 18, 3))
        p[:, :2] = rng.uniform(8 / 512, 20 / 512, (1 << 18, 2))
        wbin = rng.integers(0, 4, 1 << 18).astype(np.int32)
        y0, x0, _, _ = wproj.wproj_records(shape, 4, 15, 15, 64, _t(p),
                                           _t(wbin))
        order, items, _ = wproj.wproj_gather_plan(y0, x0, 15, 15, shape)
        assert len(set(items[0].tolist())) == 1
        assert items.shape[1] == (1 << 18) // wproj.GATHER_WINDOW
        bank = _bank(rng, 15, 15, nw=4, qpx=4, dtype=np.complex64)
        self._gather_parity(cuda_device, bank, shape, p.astype(np.float32),
                            wbin)
