"""Port parity: ska_sdp_tpu_torch.ops against the JAX reference ops.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU with float32 arrays passed explicitly (the test
session enables x64).  Integer outputs must match exactly; float outputs
within a float32 rounding bound stated per test.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ska_sdp_tpu.ops import coords as j_coords  # noqa: E402
from ska_sdp_tpu.ops import fourier as j_fourier  # noqa: E402
from ska_sdp_tpu.ops import idg as j_idg  # noqa: E402
from ska_sdp_tpu.ops import idg_aw as j_idg_aw  # noqa: E402
from ska_sdp_tpu.ops.hermitian import make_grid_hermitian as j_herm  # noqa: E402,E501
from ska_sdp_tpu.ops.weighting import doweight as j_doweight  # noqa: E402
from ska_sdp_tpu_torch.ops import coords, fourier, idg, idg_aw  # noqa: E402
from ska_sdp_tpu_torch.ops.hermitian import make_grid_hermitian  # noqa: E402
from ska_sdp_tpu_torch.ops.weighting import doweight  # noqa: E402

torch.set_num_threads(2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cplx(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


class TestCoords:
    @pytest.mark.parametrize("n,qpx", [(256, 1), (256, 8), (255, 4)])
    def test_frac_coord_exact(self, n, qpx):
        rng = np.random.default_rng(n + qpx)
        p = rng.uniform(-0.6, 0.6, 4000).astype(np.float32)
        # exact half-cell points exercise round-half-to-even
        p[:64] = (np.arange(64) - 32 + 0.5 / qpx).astype(np.float32) / n
        jc, jf = j_coords.frac_coord(n, qpx, jnp.asarray(p))
        tc, tf = coords.frac_coord(n, qpx, torch.as_tensor(p))
        np.testing.assert_array_equal(_np(jc), _np(tc))
        np.testing.assert_array_equal(_np(jf), _np(tf))

    def test_uvw_lambda_and_mirror(self):
        rng = np.random.default_rng(1)
        uvw = rng.uniform(-3e3, 3e3, (2000, 3)).astype(np.float32)
        vis = _cplx(rng, 2000)
        f = np.float32(1.5e8)
        j = j_coords.uvw_lambda(jnp.asarray(f), jnp.asarray(uvw))
        t = coords.uvw_lambda(torch.tensor(f), torch.as_tensor(uvw))
        # same float32 scale, same product: equal to the last bit
        np.testing.assert_array_equal(_np(j), _np(t))
        ju, jv = j_coords.mirror_uvw(j, jnp.asarray(vis))
        tu, tv = coords.mirror_uvw(t, torch.as_tensor(vis))
        np.testing.assert_array_equal(_np(ju), _np(tu))
        np.testing.assert_array_equal(_np(jv), _np(tv))
        assert (_np(tu)[:, 1] >= 0).all()


class TestWeighting:
    @pytest.mark.parametrize("extent", [0.42, 0.7])
    def test_doweight_matches(self, extent):
        # extent 0.7 puts records outside the grid: the port must follow
        # the reference's wrap/drop/clamp semantics for such cell ids
        rng = np.random.default_rng(7)
        theta, lam = 0.05, 5120
        uvw = (rng.uniform(-extent, extent, (3000, 3)) * lam
               ).astype(np.float32)
        uvw[:1500, :2] = np.round(uvw[:1500, :2] / 8) * 8   # shared cells
        vis = _cplx(rng, 3000)
        j = j_doweight(theta, lam, jnp.asarray(uvw), jnp.asarray(vis))
        t = doweight(theta, lam, torch.as_tensor(uvw), torch.as_tensor(vis))
        np.testing.assert_array_equal(np.isfinite(_np(j)),
                                      np.isfinite(_np(t)))
        ok = np.isfinite(_np(j))
        np.testing.assert_allclose(_np(t)[ok], _np(j)[ok], rtol=1e-6)


class TestHermitianAndFFT:
    @pytest.mark.parametrize("n", [64, 65])
    def test_make_grid_hermitian(self, n):
        g = _cplx(np.random.default_rng(n), (n, n))
        np.testing.assert_array_equal(
            _np(j_herm(jnp.asarray(g))),
            _np(make_grid_hermitian(torch.as_tensor(g))))

    @pytest.mark.parametrize("n", [64, 75])
    def test_centered_ffts(self, n):
        g = _cplx(np.random.default_rng(n), (n, n))
        # two float32 FFT libraries: agree to float32 rounding over n² terms
        for jf, tf in ((j_fourier.ifft_centered, fourier.ifft_centered),
                       (j_fourier.fft_centered, fourier.fft_centered)):
            want = _np(jf(jnp.asarray(g)))
            got = _np(tf(torch.as_tensor(g)))
            assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6

    @pytest.mark.parametrize("n0,n", [(15, 64), (16, 65), (32, 32)])
    def test_pad_and_extract_mid(self, n0, n):
        a = _cplx(np.random.default_rng(n0), (2, n0, n0))
        jp = _np(j_fourier.pad_mid(jnp.asarray(a), n))
        tp = _np(fourier.pad_mid(torch.as_tensor(a), n))
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(
            _np(j_fourier.extract_mid(jnp.asarray(jp), n0)),
            _np(fourier.extract_mid(torch.as_tensor(tp), n0)))


class TestIDGHelpers:
    @pytest.mark.parametrize("S,beta", [(32, 12.0), (64, 12.0), (64, 8.5),
                                        (128, 12.0)])
    def test_kaiser_and_fine_taper(self, S, beta):
        # both sides build the taper in float64 (x64 is on for JAX here)
        jt = _np(j_idg.kaiser_taper(S, beta, jnp.float64))
        tt = _np(idg.kaiser_taper(S, beta, torch.float64))
        np.testing.assert_allclose(tt, jt, rtol=1e-12, atol=1e-15)
        for N in (256, 2400):
            jf = _np(j_idg.taper_fine(N, S, jnp.asarray(jt)))
            tf = _np(idg.taper_fine(N, S, torch.as_tensor(tt)))
            np.testing.assert_allclose(tf, jf, rtol=1e-10, atol=1e-14)

    @pytest.mark.parametrize("fov", [None, 0.75, 0.5])
    def test_fov_pad_helpers(self, fov):
        theta, lam = 0.05, 5120
        geom = j_idg.fov_pad_geometry(theta, lam, fov)
        assert idg.fov_pad_geometry(theta, lam, fov) == geom
        n, n_grid, _, crop_lo = geom
        img = np.random.default_rng(3).standard_normal(
            (n_grid, n_grid)).astype(np.float32)
        np.testing.assert_array_equal(
            _np(j_idg.fov_pad_finish(jnp.asarray(img), n, n_grid, crop_lo)),
            _np(idg.fov_pad_finish(torch.as_tensor(img), n, n_grid,
                                   crop_lo)))

    def test_fov_pad_plan_rejects_bad_fraction(self):
        assert idg.idg_fov_pad_plan(256, 0.75) == \
            j_idg.idg_fov_pad_plan(256, 0.75)
        with pytest.raises(ValueError):
            idg.idg_fov_pad_plan(256, 1.5)

    @pytest.mark.parametrize("S", [32, 64])
    def test_dft_matrix(self, S):
        for jdt, tdt, tol in ((jnp.complex64, torch.complex64, 2e-6),
                              (jnp.complex128, torch.complex128, 1e-13)):
            want = _np(j_idg._dft_matrix(S, jdt))
            got = _np(idg._dft_matrix(S, tdt))
            assert np.abs(got - want).max() < tol

    @pytest.mark.parametrize("S,s", [(32, 15), (64, 15), (128, 15),
                                     (64, 7)])
    def test_auto_fit_margin(self, S, s):
        assert idg_aw.auto_fit_margin(S, s) == j_idg_aw.auto_fit_margin(S, s)

    def test_aw_screens_host(self):
        rng = np.random.default_rng(5)
        ak = _cplx(rng, (4, 5, 5), np.complex128)
        np.testing.assert_allclose(
            idg_aw.aw_screens_host(ak, 64, fov_scale=1.25),
            j_idg_aw.aw_screens_host(ak, 64, fov_scale=1.25), rtol=1e-12,
            atol=1e-12)
        delta = np.zeros((2, 5, 5)); delta[:, 2, 2] = 1.0
        np.testing.assert_allclose(idg_aw.aw_screens_host(delta, 32),
                                   np.ones((2, 32, 32)), atol=1e-12)
