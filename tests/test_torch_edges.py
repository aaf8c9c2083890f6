"""Port parity for the edges of the JAX package: ``fft_pow2`` /
``ifft_pow2``, the pattern options of ``KernelOptions`` in
``kernel_coordinates`` and the w-kernel bank, ``tapered_w_bank``, and the
cross-method checks that hold IDG and IDG-AW against the exact scatters on
the tapered bank.

Inputs come from numpy with a seed and go to both packages (JAX on the
CPU, x64).  Bounds:

* 1e-12 (float64, relative to the largest entry): ``fft_pow2``,
  ``ifft_pow2``, the bank with pattern options, ``tapered_w_bank``;
* equal: ``kernel_coordinates`` with a shift and a transform, and the
  default options against no options;
* 3e-4 (rel-L2 over the central 75% of the taper-corrected images, the
  JAX tests' bound and sizes): IDG (``kernels.idg_gridder``) against the
  bank scatter (``kernels.wproj_gridder``) fed with ``tapered_w_bank`` on
  uv snapped to the qpx=8 lattice, and IDG-AW (``kernels.idg_aw_gridder``)
  against the AW scatter (``kernels.aw_gridder``) fed with the conjugated
  tapered bank and near-delta A-kernels.  On the CPU these run the plain
  versions; the ``cuda`` tests run the same pairs through
  ``csrc/idg_grid.cu``, ``csrc/wproj_grid.cu`` and ``csrc/aw_grid.cu``
  and skip without a card.
"""

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch import kernels
from ska_sdp_tpu_torch.config import KernelOptions
from ska_sdp_tpu_torch.ops.fourier import (fft_pow2, ifft_centered,
                                           ifft_pow2)
from ska_sdp_tpu_torch.ops.idg import kaiser_taper, taper_fine, tapered_w_bank
from ska_sdp_tpu_torch.ops.idg_aw import aw_screens_host
from ska_sdp_tpu_torch.ops.search import find_closest
from ska_sdp_tpu_torch.ops.wkernel import kernel_coordinates, w_kernel_bank

torch.set_num_threads(2)

N, THETA, S, BETA = 256, 0.05, 32, 12.0
SA = 64                  # IDG-AW subgrids need the taper's fit margin
NW, WMAX = 8, 250.0
CROSS_TOL = 3e-4
PATTERNS = [
    {},
    dict(pat_hor_shift=1, pat_ver_shift=-2),
    dict(pat_trans_mat=(0.9, 0.2, -0.1, 1.1)),
    dict(pat_trans_mat=(0.0, 1.0, 1.0, 0.0), pat_hor_shift=1),
]
# the shifts are whole units of l and m, which put every screen point past
# the horizon (NaN in both packages): the banks take the transforms only
BANK_PATTERNS = [{}, PATTERNS[2], dict(pat_trans_mat=(0.0, 1.0, 1.0, 0.0))]


@pytest.fixture(scope="module")
def j():
    """The JAX reference, imported only by the tests that compare with it,
    so the ``cuda`` tests also run where jax is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from ska_sdp_tpu import config, ops
    from ska_sdp_tpu.ops import idg

    return jnp, config, ops, idg


def _close(got, ref, tol=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


class TestFftPow2:
    @pytest.mark.parametrize("n", [5, 8, 12, 33])
    def test_matches_jax(self, j, n):
        jnp, _, ops, _ = j
        from ska_sdp_tpu.ops.fourier import fft_pow2 as jf, ifft_pow2 as ji

        rng = np.random.default_rng(n)
        a = rng.standard_normal((2, n, n)) + 1j * rng.standard_normal(
            (2, n, n))
        _close(fft_pow2(torch.from_numpy(a)).numpy(), jf(jnp.asarray(a)))
        _close(ifft_pow2(torch.from_numpy(a)).numpy(), ji(jnp.asarray(a)))

    def test_pow2_size_is_the_centred_transform(self):
        a = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (16, 16)) + 0j)
        torch.testing.assert_close(ifft_pow2(a), ifft_centered(a))


class TestPatternOptions:
    @pytest.mark.parametrize("kw", PATTERNS)
    def test_kernel_coordinates_match_jax(self, j, kw):
        _, config, ops, _ = j
        l, m = kernel_coordinates(8, 0.1, KernelOptions(**kw))
        jl, jm = ops.kernel_coordinates(8, 0.1, config.KernelOptions(**kw))
        np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))

    def test_default_options_are_the_identity(self):
        l0, m0 = kernel_coordinates(8, 0.1)
        l1, m1 = kernel_coordinates(8, 0.1, KernelOptions())
        assert torch.equal(l0, l1) and torch.equal(m0, m1)

    @pytest.mark.parametrize("kw", BANK_PATTERNS)
    def test_bank_matches_jax(self, j, kw):
        jnp, config, ops, _ = j
        centers = np.linspace(-300.0, 300.0, 4)
        opts = dict(qpx=2, npix_ff=32, npix_kern=7, **kw)
        got = w_kernel_bank(0.1, torch.from_numpy(centers),
                            KernelOptions(**opts))
        ref = ops.w_kernel_bank(0.1, jnp.asarray(centers),
                                config.KernelOptions(**opts))
        _close(got.numpy(), ref)


class TestTaperedBank:
    @pytest.mark.parametrize("kw", BANK_PATTERNS[:2])
    def test_matches_jax(self, j, kw):
        jnp, config, _, idg = j
        centers = np.linspace(-WMAX, WMAX, NW)
        opts = dict(qpx=4, npix_ff=64, npix_kern=9, **kw)
        got = tapered_w_bank(THETA, torch.from_numpy(centers),
                             KernelOptions(**opts), BETA, S)
        ref = idg.tapered_w_bank(THETA, jnp.asarray(centers),
                                 config.KernelOptions(**opts), BETA, S)
        _close(got.numpy(), ref)

    def test_zero_beta_is_the_plain_bank(self):
        centers = torch.linspace(-WMAX, WMAX, 3, dtype=torch.float64)
        opts = KernelOptions(qpx=2, npix_ff=32, npix_kern=7)
        torch.testing.assert_close(
            tapered_w_bank(THETA, centers, opts, 0.0, S),
            w_kernel_bank(THETA, centers, opts), rtol=0, atol=1e-12)


# ---- the cross-method checks (tests/test_idg.py's problems) --------------
def _problem(rng, b=300):
    """The reference test's uniform records, uv snapped to the qpx=8
    lattice."""
    p = rng.uniform(-0.42, 0.42, (b, 3))
    p[:, :2] = np.round(p[:, :2] * (8 * N)) / (8 * N)
    w = rng.uniform(-WMAX, WMAX, b).astype(np.float32)
    vis = (rng.standard_normal(b) + 1j * rng.standard_normal(b)).astype(
        np.complex64)
    return p.astype(np.float32), w, vis


def _track_problem(rng, nant=6, ntime=96, nchan=4):
    """The reference test's baseline tracks, time-major with channels
    inner, uv snapped to the qpx=8 lattice."""
    pairs = [(i, jj) for i in range(nant) for jj in range(i + 1, nant)]
    nbl = len(pairs)
    u0 = rng.uniform(-0.30, 0.30, (nbl, 2))
    du = rng.uniform(-15.0 / N, 15.0 / N, (nbl, 2))
    w0 = rng.uniform(-WMAX, WMAX, nbl)
    dw = rng.uniform(-20.0, 20.0, nbl)
    fscale = 1.0 + 0.002 * np.arange(nchan)
    ft = (np.arange(ntime) / ntime)[:, None, None]
    uv = (u0[None, :, None, :] + du[None, :, None, :] * ft[..., None]) \
        * fscale[None, None, :, None]
    shape = (ntime, nbl, nchan)
    p = np.zeros((np.prod(shape), 3))
    p[:, :2] = np.round(uv.reshape(-1, 2) * (8 * N)) / (8 * N)
    w = np.broadcast_to(w0[None, :, None] + dw[None, :, None] * ft,
                        shape).ravel()
    ij = np.asarray(pairs)
    a1 = np.broadcast_to(ij[None, :, None, 0], shape).ravel()
    a2 = np.broadcast_to(ij[None, :, None, 1], shape).ravel()
    vis = rng.standard_normal(p.shape[0]) + 1j * rng.standard_normal(
        p.shape[0])
    return p, w, a1.astype(np.int32), a2.astype(np.int32), vis, nbl


def _near_delta_akerns(rng, nant, s=15):
    """Unit centre taps with 5% noise on the central 3×3 (the reference
    truncates (a1 ⊛ a2) ⊛ w to s taps: broad A-tails diverge through
    truncation alone)."""
    ak = np.zeros((nant, s, s), np.complex128)
    c = s // 2
    ak[:, c, c] = 1.0
    ak[:, c - 1:c + 2, c - 1:c + 2] += 0.05 * (
        rng.standard_normal((nant, 3, 3))
        + 1j * rng.standard_normal((nant, 3, 3)))
    return ak


def _corrected(grid, subgrid):
    tf = taper_fine(N, subgrid, kaiser_taper(subgrid, BETA))
    img = ifft_centered(grid.to(torch.complex128)).cpu()
    return (img / torch.outer(tf, tf)).numpy()


def _rel75(a, b):
    c = slice(N // 8, N - N // 8)
    return np.linalg.norm((a - b)[c, c]) / np.linalg.norm(b[c, c])


def idg_vs_tapered_scatter(dev, seed):
    """rel-L2 of IDG (S=32) against the bank scatter on the tapered
    bank."""
    p, w, vis = _problem(np.random.default_rng(seed))
    opts = KernelOptions(qpx=8, npix_ff=256, npix_kern=15)
    centers = torch.linspace(-WMAX, WMAX, NW, dtype=torch.float32,
                             device=dev)
    pt, wt = torch.from_numpy(p).to(dev), torch.from_numpy(w).to(dev)
    vt = torch.from_numpy(vis).to(dev)
    wbin = find_closest(centers, wt)
    bank = tapered_w_bank(THETA, centers, opts, BETA, S, dtype=torch.float32,
                          device=dev).to(torch.complex64)
    g_bank = kernels.wproj_gridder(bank, (N, N), pt, wbin, vt)
    g_idg, nd = kernels.idg_gridder((N, N), pt, centers[wbin.long()], vt,
                                    theta=THETA, subgrid=S, taper_beta=BETA)
    assert int(nd) == 0
    return _rel75(_corrected(g_idg, S), _corrected(g_bank, S))


def idg_aw_vs_aw_scatter(dev, seed):
    """rel-L2 of IDG-AW (S=64) against the AW scatter on the conjugated
    tapered bank with near-delta A-kernels, and IDG-AW's drop count."""
    rng = np.random.default_rng(seed)
    p, w, a1, a2, vis, nbl = _track_problem(rng)
    nant = int(max(a1.max(), a2.max())) + 1
    ak = _near_delta_akerns(rng, nant)
    opts = KernelOptions(qpx=8, npix_ff=256, npix_kern=15)
    centers = torch.linspace(-WMAX, WMAX, NW, dtype=torch.float64,
                             device=dev)
    pt = torch.from_numpy(p.astype(np.float32)).to(dev)
    wbin = find_closest(centers, torch.from_numpy(w).to(dev))
    ia1, ia2 = torch.from_numpy(a1).to(dev), torch.from_numpy(a2).to(dev)
    vt = torch.from_numpy(vis.astype(np.complex64)).to(dev)
    bank = tapered_w_bank(THETA, centers, opts, BETA, SA, device=dev)
    g_aw = kernels.aw_gridder(
        torch.conj(bank).resolve_conj().to(torch.complex64),
        torch.from_numpy(ak).to(dev, torch.complex64),
        torch.zeros((N, N), dtype=torch.complex64, device=dev), pt, wbin,
        ia1, ia2, vt)
    scr = torch.from_numpy(aw_screens_host(ak, SA)).to(dev, torch.complex64)
    g_idg, nd = kernels.idg_aw_gridder(
        (N, N), pt, ia1, ia2, centers[wbin.long()].float(), vt, scr,
        theta=THETA, subgrid=SA, taper_beta=BETA,
        max_runs=8 * nbl + p.shape[0] // 128 + 64)
    return _rel75(_corrected(g_idg, SA), _corrected(g_aw, SA)), int(nd)


class TestCrossMethod:
    def test_idg_matches_tapered_bank_scatter(self):
        assert idg_vs_tapered_scatter(torch.device("cpu"), 11) < CROSS_TOL

    def test_idg_aw_matches_aw_scatter(self):
        rel, nd = idg_aw_vs_aw_scatter(torch.device("cpu"), 12)
        assert nd == 0
        assert rel < CROSS_TOL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
class TestCrossMethodOnCard:
    def test_idg_matches_tapered_bank_scatter(self, cuda_device):
        from ska_sdp_tpu_torch.kernels import idg_aw_stream, idg_tile, wproj

        wproj.reset_launch_count()
        idg_tile.reset_launch_count()
        idg_aw_stream.reset_launch_count()
        assert idg_vs_tapered_scatter(cuda_device, 11) < CROSS_TOL
        assert wproj.launch_count(wproj.GRID_KERNEL) == 1
        assert idg_aw_stream.launch_count(idg_aw_stream.GRID_KERNEL) == 1

    def test_idg_aw_matches_aw_scatter(self, cuda_device):
        from ska_sdp_tpu_torch.kernels import aw_fused, idg_aw_stream

        aw_fused.reset_launch_count()
        idg_aw_stream.reset_launch_count()
        rel, nd = idg_aw_vs_aw_scatter(cuda_device, 12)
        assert nd == 0 and rel < CROSS_TOL
        assert aw_fused.launch_count(aw_fused.GRID_KERNEL) == 1
        assert idg_aw_stream.launch_count(idg_aw_stream.GRID_KERNEL) == 1
