"""Port parity for model-visibility prediction (IDG and IDG-AW degridding).

* ``fov_pad_start`` against the JAX function;
* the port's ``_idg_predict_pipeline`` against the JAX pieces composed on
  the CPU around ``ops.idg_aw.idg_degrid_aw`` with unit screens and zero
  pair ids (the same (pair, tile) operator): rel-L2 ≤ 5e-5, the reference's
  stream-vs-oracle bound; against the JAX ``_idg_predict_pipeline`` itself,
  which on the CPU runs the fixed-tile XLA degridder (another tiling), at
  method level (0.03);
* the port's ``_aw_idg_predict_pipeline`` against the JAX one, which runs
  ``idg_degrid_aw`` on the CPU: rel-L2 ≤ 5e-5;
* a point source against its direct-DFT truth: max |err| ≤ 2e-4, the bound
  of the reference's point-source test;
* the file entry at the reference's default ``subgrid=32`` (the fixed-tile
  degridder) against the JAX file entry: rel-L2 ≤ 5e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ska_sdp_tpu.kernels import _idg_unit_run_bound  # noqa: E402
from ska_sdp_tpu.models import dataset as j_ds  # noqa: E402
from ska_sdp_tpu.ops import fft_centered as j_fft_centered  # noqa: E402
from ska_sdp_tpu.ops import idg as j_idg  # noqa: E402
from ska_sdp_tpu.ops.idg_aw import idg_degrid_aw  # noqa: E402
from ska_sdp_tpu_torch import SPEED_OF_LIGHT, kernels  # noqa: E402
from ska_sdp_tpu_torch.config import GridParams, ImagingConfig  # noqa: E402
from ska_sdp_tpu_torch.io import h5, schema  # noqa: E402
from ska_sdp_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticConfig, simulate_observation, write_vis_file)
from ska_sdp_tpu_torch.models import dataset as ds  # noqa: E402
from ska_sdp_tpu_torch.ops import fft_centered  # noqa: E402
from ska_sdp_tpu_torch.ops.idg import (fov_pad_start, kaiser_taper,  # noqa: E402,E501
                                       taper_fine)
from ska_sdp_tpu_torch.ops.idg_aw import aw_screens_host  # noqa: E402

torch.set_num_threads(2)

THETA, LAM, N, S, BETA = 0.05, 5120, 256, 64, 12.0
TOL = 5e-5


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def observation():
    obs = simulate_observation(SyntheticConfig(theta=THETA, lam=LAM,
                                               nant=10, ntime=12))
    vd = ds.vis_data_from_observation(obs)
    img = np.zeros((N, N), np.float32)
    for l, m, flux in obs["sources"]:
        img[int(round(N / 2 + m * LAM)), int(round(N / 2 + l * LAM))] = flux
    return vd, img


@pytest.fixture(scope="module")
def akerns():
    rng = np.random.default_rng(5)
    ak = np.zeros((10, 15, 15), np.complex128)
    ak[:, 7, 7] = 1.0
    ak += 0.05 * (rng.standard_normal(ak.shape)
                  + 1j * rng.standard_normal(ak.shape))
    return ak


def _inputs(vd):
    return (np.asarray(vd.uvw, np.float32),
            np.asarray(vd.frequency, np.float32))


def _jax_idg_predict_pieces(img, uvw, f, fov_pad):
    """JAX's predict pieces around the XLA IDG-AW degridder with unit
    screens and zero pair ids, at the streamed route's run bound."""
    uvw0 = jnp.asarray(uvw) * (jnp.asarray(f) / SPEED_OF_LIGHT)
    n, n_grid, theta_g, crop_lo = j_idg.fov_pad_geometry(THETA, LAM, fov_pad)
    imgp = j_idg.fov_pad_start(jnp.asarray(img), n, n_grid, crop_lo)
    tf = j_idg.taper_fine(n_grid, S, j_idg.kaiser_taper(S, BETA))
    tf2 = (tf[:, None] * tf[None, :]).astype(jnp.float32)
    grid = j_fft_centered((imgp / tf2).astype(jnp.complex64))
    b = uvw.shape[0]
    zer = jnp.zeros((b,), jnp.int32)
    vis, nd = idg_degrid_aw(
        (n_grid, n_grid), uvw0 / LAM, zer, zer, uvw0[:, 2], grid,
        jnp.ones((1, S, S), jnp.complex64), theta=theta_g, subgrid=S,
        taper_beta=BETA,
        max_runs=_idg_unit_run_bound((n_grid, n_grid), S, 15))
    return np.asarray(vis), int(nd)


class TestFovPadStart:
    @pytest.mark.parametrize("fov_pad", [None, 0.75, 0.6])
    def test_matches_jax(self, fov_pad):
        rng = np.random.default_rng(3)
        img = rng.standard_normal((N, N)).astype(np.float32)
        n, n_grid, _, crop_lo = j_idg.fov_pad_geometry(THETA, LAM, fov_pad)
        want = np.asarray(j_idg.fov_pad_start(jnp.asarray(img), n, n_grid,
                                              crop_lo))
        got = fov_pad_start(torch.as_tensor(img), n, n_grid, crop_lo)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


class TestIDGPredict:
    @pytest.mark.parametrize("fov_pad", [None, 0.75])
    def test_matches_jax_pieces(self, observation, fov_pad):
        vd, img = observation
        uvw, f = _inputs(vd)
        want, nd_want = _jax_idg_predict_pieces(img, uvw, f, fov_pad)
        got, nd = ds._idg_predict_pipeline(
            torch.as_tensor(img), torch.as_tensor(uvw), torch.as_tensor(f),
            theta=THETA, lam=LAM, subgrid=S, taper_beta=BETA,
            fov_pad=fov_pad)
        assert int(nd) == nd_want == 0
        assert got.dtype == torch.complex64
        assert _rel(got.numpy(), want) < TOL

    def test_method_level_vs_jax_fixed_tile_pipeline(self, observation):
        vd, img = observation
        uvw, f = _inputs(vd)
        want = np.asarray(j_ds._idg_predict_pipeline(
            img, uvw, f, theta=THETA, lam=LAM, subgrid=S, taper_beta=BETA))
        res = ds.idg_predict_vis(vd, img, theta=THETA, lam=LAM, subgrid=S,
                                 device="cpu")
        assert res.n_dropped == 0
        assert _rel(res.vis.numpy(), want) < 0.03
        assert res.peak == pytest.approx(float(res.vis.abs().max()))

    def test_point_source_matches_direct_dft(self):
        rng = np.random.default_rng(7)
        b = 300
        p = rng.uniform(-0.42, 0.42, (b, 3)).astype(np.float32)
        w = rng.uniform(-250.0, 250.0, b).astype(np.float32)
        py, px = 150, 170
        img = np.zeros((N, N), np.float32)
        img[py, px] = 1.0
        tf = taper_fine(N, S, kaiser_taper(S, BETA)).numpy()
        grid = fft_centered(torch.as_tensor(
            (img / np.outer(tf, tf)).astype(np.complex64)))
        pred, nd = kernels.idg_degridder(
            (N, N), torch.as_tensor(p), torch.as_tensor(w), grid,
            theta=THETA, subgrid=S)
        assert int(nd) == 0
        l0 = (px - N // 2) / N
        m0 = (py - N // 2) / N
        n0 = 1.0 - np.sqrt(1.0 - (l0 * THETA)**2 - (m0 * THETA)**2)
        true = (np.exp(-2j * np.pi * (p[:, 0] * N * l0 + p[:, 1] * N * m0))
                * np.exp(2j * np.pi * w * n0))
        assert np.abs(pred.numpy() - true).max() < 2e-4

    def test_file_entry_default_subgrid_names_fixed_tile_kernel(
            self, tmp_path, observation):
        obs = simulate_observation(SyntheticConfig(theta=THETA, lam=LAM,
                                                   nant=6, ntime=4))
        vis = str(tmp_path / "vis.h5")
        model = str(tmp_path / "model.h5")
        write_vis_file(vis, obs)
        h5.create_file(model)
        h5.write_dataset(model, schema.IMG_DATASET,
                         observation[1].astype(np.float64))
        cfg = ImagingConfig(grid=GridParams(theta=THETA, lam=LAM))
        # the reference's default S=32 (support 15) runs on the fixed-tile
        # degridder; the JAX entry on the CPU runs its fixed-tile XLA
        # degridder, the same tiling
        got, peak = ds.idg_predict(vis, model, config=cfg, device="cpu")
        from ska_sdp_tpu.config import GridParams as JGridParams
        from ska_sdp_tpu.config import ImagingConfig as JImagingConfig

        j_cfg = JImagingConfig(grid=JGridParams(theta=THETA, lam=LAM))
        want, j_peak = j_ds.idg_predict(vis, model, config=j_cfg)
        assert got.shape == want.shape == (obs["n"],)
        assert _rel(got, want) < TOL
        assert abs(peak - j_peak) < TOL * j_peak
        with pytest.raises(ValueError, match="does not match grid"):
            ds.idg_predict(vis, model, device="cpu", subgrid=64)


class TestAWPredict:
    @pytest.mark.parametrize("fov_pad", [None, 0.75])
    def test_matches_jax_pipeline(self, observation, akerns, fov_pad):
        vd, img = observation
        uvw, f = _inputs(vd)
        a1 = np.asarray(vd.antenna1, np.int64)
        a2 = np.asarray(vd.antenna2, np.int64)
        n = uvw.shape[0]
        mr = ds._aw_run_bound(a1, a2, n)
        n_t, n_g, _, _ = j_idg.fov_pad_geometry(THETA, LAM, fov_pad)
        scr = aw_screens_host(akerns.astype(np.complex64), S,
                              fov_scale=n_g / n_t).astype(np.complex64)
        want, nd_want = j_ds._aw_idg_predict_pipeline(
            scr, img, uvw, a1.astype(np.int32), a2.astype(np.int32), f,
            theta=THETA, lam=LAM, subgrid=S, taper_beta=BETA, max_runs=mr,
            fov_pad=fov_pad)
        res = ds.aw_predict_vis(vd, akerns, img, theta=THETA, lam=LAM,
                                subgrid=S, fov_pad=fov_pad, device="cpu")
        assert res.n_dropped == int(nd_want) == 0
        assert _rel(res.vis.numpy(), np.asarray(want)) < TOL

    def test_unit_akerns_equal_plain_idg(self, observation):
        # delta A-kernels give unit screens: IDG-AW predict is plain IDG
        vd, img = observation
        ak = np.zeros((10, 15, 15), np.complex128)
        ak[:, 7, 7] = 1.0
        aw = ds.aw_predict_vis(vd, ak, img, theta=THETA, lam=LAM,
                               device="cpu")
        idg = ds.idg_predict_vis(vd, img, theta=THETA, lam=LAM, device="cpu")
        assert _rel(aw.vis.numpy(), idg.vis.numpy()) < 1e-5
