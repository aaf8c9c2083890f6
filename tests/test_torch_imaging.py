"""Port parity: the PSF-normalised imaging pipeline and the three imaging
modes it runs (``--mode simple``, ``conv``, ``wcache``).

The same numpy inputs, made from a seed, go through the JAX functions
(CPU, x64 as ``tests/conftest.py`` sets it) and the port's (CPU: the bank
scatter ``kernels.wproj_gridder`` takes its plain version).  Bounds:

* ``to_grid_cell``: exact (round half up, half-cell inputs included);
* ``grid_nearest`` and ``convgrid``: rel-L2 ≤ 1e-6;
* ``w_cache_imaging`` with and without ``w_range``: the per-visibility
  bins exactly (w on bin edges included), the grid ≤ 5e-5;
* ``do_imaging`` for the three modes at 256²: image and PSF ≤ 1e-4, the
  PSF peak ≤ 1e-5 relative;
* the CLI on a ``--make-data`` set against the JAX CLI's ``/img``: ≤ 1e-4,
  with ``--wstep`` honoured.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch import cli
from ska_sdp_tpu_torch.config import KernelOptions
from ska_sdp_tpu_torch.io import h5, inputs, schema
from ska_sdp_tpu_torch.io.synthetic import (SyntheticConfig, generate_dataset,
                                            simulate_observation)
from ska_sdp_tpu_torch.models import dataset as ds
from ska_sdp_tpu_torch.models import imaging
from ska_sdp_tpu_torch.ops import uvw_lambda
from ska_sdp_tpu_torch.ops.coords import to_grid_cell
from ska_sdp_tpu_torch.ops.gridding import convgrid, grid_nearest
from ska_sdp_tpu_torch.ops.wkernel import w_kernel_bank

torch.set_num_threads(2)

THETA, LAM = 0.05, 5120          # 256²
N = 256
OPTS = dict(qpx=4, npix_ff=64, npix_kern=7)      # a small bank for speed


@pytest.fixture(scope="module")
def j():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from ska_sdp_tpu import cli as j_cli
    from ska_sdp_tpu import kernels as j_kernels
    from ska_sdp_tpu.config import KernelOptions as JKernelOptions
    from ska_sdp_tpu.models import imaging as j_imaging
    from ska_sdp_tpu.ops import coords as j_coords
    from ska_sdp_tpu.ops import gridding as j_gridding
    from ska_sdp_tpu.ops import uvw_lambda as j_uvw_lambda
    from ska_sdp_tpu.ops import w_kernel_bank as j_w_kernel_bank

    return SimpleNamespace(jnp=jnp, cli=j_cli, kernels=j_kernels,
                           KernelOptions=JKernelOptions, imaging=j_imaging,
                           coords=j_coords, gridding=j_gridding,
                           uvw_lambda=j_uvw_lambda,
                           w_kernel_bank=j_w_kernel_bank)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _records(seed, n=3000, extent=0.52, wmax=7000.0, dtype=np.float32):
    """``(uvw [n, 3] in wavelengths, vis [n])``: uv beyond the grid's
    edges, w over several 2000-λ bins with some w exactly on bin edges."""
    rng = np.random.default_rng(seed)
    uvw = np.zeros((n, 3), dtype)
    uvw[:, :2] = rng.uniform(-extent, extent, (n, 2)) * LAM
    uvw[:, 2] = rng.uniform(-wmax, wmax, n)
    uvw[:40, 2] = 1000.0 * rng.integers(-7, 8, 40)     # half-bin ties
    vis = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64 if dtype == np.float32 else np.complex128)
    return uvw, vis


class TestOps:
    @pytest.mark.parametrize("n", [256, 255])
    def test_to_grid_cell_exact(self, j, n):
        rng = np.random.default_rng(n)
        f = rng.uniform(-0.6, 0.6, 5000).astype(np.float32)
        f[:200] = (rng.integers(-n, n, 200) + 0.5) / n    # half-cell inputs
        got = to_grid_cell(n, torch.as_tensor(f)).numpy()
        want = np.asarray(j.coords.to_grid_cell(n, j.jnp.asarray(f)))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_grid_nearest(self, j, dtype):
        uvw, vis = _records(3, dtype=dtype)
        p = uvw / LAM
        guv = np.zeros((N, N), vis.dtype)
        got = grid_nearest(torch.as_tensor(guv), torch.as_tensor(p),
                           torch.as_tensor(vis)).numpy()
        want = np.asarray(j.gridding.grid_nearest(
            j.jnp.asarray(guv), j.jnp.asarray(p), j.jnp.asarray(vis)))
        assert got.dtype == want.dtype
        assert _rel(got, want) < 1e-6

    def test_convgrid(self, j):
        uvw, vis = _records(4)
        p = uvw / LAM
        rng = np.random.default_rng(5)
        gcf = (rng.standard_normal((4, 4, 7, 7))
               + 1j * rng.standard_normal((4, 4, 7, 7))).astype(np.complex64)
        guv = np.zeros((N, N), np.complex64)
        got = convgrid(torch.as_tensor(gcf), torch.as_tensor(guv),
                       torch.as_tensor(p), torch.as_tensor(vis),
                       chunk=512).numpy()
        want = np.asarray(j.gridding.convgrid(
            j.jnp.asarray(gcf), j.jnp.asarray(guv), j.jnp.asarray(p),
            j.jnp.asarray(vis), chunk=512))
        assert _rel(got, want) < 1e-6


class TestImagingFunctions:
    @pytest.mark.parametrize("w_range", [None, (-6100.0, 4900.0),
                                         (-9000.0, 9000.0)])
    def test_w_cache_imaging(self, j, monkeypatch, w_range):
        uvw, vis = _records(6)
        seen = {}
        real_gridder = j.kernels.wproj_gridder

        def spy(bank, shape, p, wbin, v, chunk):
            seen["nw"], seen["wbin"] = bank.shape[0], np.asarray(wbin)
            return real_gridder(bank, shape, p, wbin, v, chunk=chunk)

        monkeypatch.setattr(j.kernels, "wproj_gridder", spy)
        want = np.asarray(j.imaging.w_cache_imaging(
            THETA, LAM, j.jnp.asarray(uvw), None, j.jnp.asarray(vis),
            opts=j.KernelOptions(**OPTS), w_range=w_range))
        centers, wbin = imaging.w_cache_bins(torch.as_tensor(uvw), 2000,
                                             w_range)
        np.testing.assert_array_equal(wbin.numpy(), seen["wbin"])
        assert wbin.dtype == torch.int32
        assert centers.shape == (seen["nw"],)
        got = imaging.w_cache_imaging(
            THETA, LAM, torch.as_tensor(uvw), None, torch.as_tensor(vis),
            opts=KernelOptions(**OPTS), w_range=w_range).numpy()
        assert _rel(got, want) < 5e-5

    def test_wproj_imaging_from_bank(self, j):
        uvw, vis = _records(7)
        centers = np.linspace(-7000.0, 7000.0, 8)
        bank = w_kernel_bank(THETA, torch.as_tensor(centers),
                             KernelOptions(**OPTS), dtype=torch.float32)
        got = imaging.wproj_imaging_from_bank(
            bank, torch.as_tensor(centers, dtype=torch.float32), THETA, LAM,
            torch.as_tensor(uvw), None, torch.as_tensor(vis)).numpy()
        jnp = j.jnp
        want = np.asarray(j.imaging.wproj_imaging_from_bank(
            jnp.asarray(bank.numpy()), jnp.asarray(centers, jnp.float32),
            THETA, LAM, jnp.asarray(uvw), None, jnp.asarray(vis)))
        assert _rel(got, want) < 5e-5

    def test_mode_imgfn(self):
        uvw = torch.as_tensor(_records(8)[0])
        assert imaging.mode_imgfn("simple", THETA, uvw) is \
            imaging.simple_imaging
        assert imaging.mode_imgfn("wcache", THETA, uvw,
                                    wstep=500).keywords["opts"].wstep == 500
        kv = imaging.mode_imgfn("conv", THETA, uvw).args[0]
        assert kv.shape == (8, 8, 15, 15) and kv.dtype == torch.complex64
        assert imaging.aw_imaging_old is imaging.aw_imaging
        with pytest.raises(ValueError, match="no imaging function"):
            imaging.mode_imgfn("w", THETA, uvw)


OBS = SyntheticConfig(theta=THETA, lam=LAM, nant=10, ntime=6, nw_planes=8,
                      qpx=4)


@pytest.fixture(scope="module")
def obs_vd():
    return inputs.vis_data_from_observation(simulate_observation(OBS))


@pytest.fixture(scope="module")
def obs_data(tmp_path_factory):
    paths, obs = generate_dataset(str(tmp_path_factory.mktemp("drv")), OBS)
    return paths, inputs.vis_data_from_observation(obs)


def _jax_imgfn(j, mode, uvw0, wstep=2000.0):
    """The JAX CLI's imaging function of ``mode`` (``ska_sdp_tpu/cli.py``'s
    simple / conv / wcache branch)."""
    jnp = j.jnp
    if mode == "simple":
        return j.imaging.simple_imaging
    if mode == "wcache":
        opts = j.KernelOptions(wstep=wstep)
        return lambda th, lam, uvw, src, vis: j.imaging.w_cache_imaging(
            th, lam, uvw, src, vis, opts=opts)
    w_mid = float(np.abs(np.asarray(uvw0[:, 2])).mean())
    kv = j.w_kernel_bank(THETA, jnp.asarray([w_mid], jnp.float32),
                         j.KernelOptions(), dtype=jnp.float32)[0]
    return lambda th, lam, uvw, src, vis: j.imaging.conv_imaging(
        kv, th, lam, uvw, src, vis)


class TestDoImaging:
    @pytest.mark.parametrize("mode", ["simple", "conv", "wcache"])
    def test_matches_jax_do_imaging(self, j, obs_vd, mode):
        vd = obs_vd
        got = ds.psf_image(vd, mode, theta=THETA, lam=LAM, device="cpu")
        jnp = j.jnp
        uvw0 = j.uvw_lambda(vd.frequency, jnp.asarray(vd.uvw, jnp.float32))
        want = j.imaging.do_imaging(
            THETA, LAM, uvw0, jnp.asarray(vd.antenna1),
            jnp.asarray(vd.antenna2), jnp.asarray(vd.time, jnp.float32),
            vd.frequency, jnp.asarray(vd.vis, jnp.complex64),
            _jax_imgfn(j, mode, uvw0))
        assert got.image.shape == got.psf.shape == (N, N)
        assert got.image.dtype == torch.float32
        assert _rel(got.image.numpy(), np.asarray(want.image)) < 1e-4
        assert _rel(got.psf.numpy(), np.asarray(want.psf)) < 1e-4
        assert abs(float(got.pmax) / float(want.pmax) - 1.0) < 1e-5
        # both normalised by the PSF peak
        assert float(got.psf.max()) == pytest.approx(1.0, abs=1e-6)

    def test_double_precision(self, j, obs_vd):
        vd = obs_vd
        got = ds.psf_image(vd, "simple", theta=THETA, lam=LAM,
                              precision="double", device="cpu")
        jnp = j.jnp
        uvw0 = j.uvw_lambda(vd.frequency, jnp.asarray(vd.uvw, jnp.float64))
        want = j.imaging.do_imaging(
            THETA, LAM, uvw0, jnp.asarray(vd.antenna1),
            jnp.asarray(vd.antenna2), jnp.asarray(vd.time), vd.frequency,
            jnp.asarray(vd.vis, jnp.complex128), j.imaging.simple_imaging)
        assert got.image.dtype == torch.float64
        assert _rel(got.image.numpy(), np.asarray(want.image)) < 1e-10


class TestCli:
    @pytest.mark.parametrize("argv", [["--mode", "simple"],
                                      ["--mode", "conv"],
                                      ["--mode", "wcache"],
                                      ["--mode", "wcache", "--wstep", "300"]])
    def test_matches_jax_cli(self, j, obs_data, tmp_path, argv, capsys):
        paths, _ = obs_data
        d = os.path.dirname(paths["vis"])
        geo = ["--theta", str(THETA), "--lam", str(LAM)]
        out_t, out_j = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
        # only vis.h5 is needed
        only_vis = tmp_path / "vis_only"
        only_vis.mkdir()
        os.symlink(paths["vis"], only_vis / "vis.h5")
        assert cli.main([*argv, "-i", str(only_vis), "--all", "-o", out_t,
                         "--device", "cpu", *geo]) == 0
        said = capsys.readouterr().out
        assert j.cli.main([*argv, "-i", d, "--all", "-o", out_j,
                           "--backend", "cpu", *geo]) == 0
        j_said = capsys.readouterr().out
        got = h5.read_dataset(out_t, schema.IMG_DATASET)
        want = h5.read_dataset(out_j, schema.IMG_DATASET)
        assert got.shape == want.shape == (N, N)
        assert got.dtype == want.dtype
        assert _rel(got, want) < 1e-4
        # "image max" is the PSF peak, as the reference prints it
        pmax = float(said.split("image max: ")[1].split()[0])
        j_pmax = float(j_said.split("image max: ")[1].split()[0])
        assert abs(pmax / j_pmax - 1.0) < 1e-5

    def test_wstep_is_honoured(self, obs_data, tmp_path):
        paths, vd = obs_data
        d = os.path.dirname(paths["vis"])
        imgs = []
        for wstep in ("2000", "300"):
            out = str(tmp_path / f"w{wstep}.h5")
            assert cli.main(["--mode", "wcache", "-i", d, "--all", "-o", out,
                             "--device", "cpu", "--wstep", wstep,
                             "--theta", str(THETA), "--lam", str(LAM)]) == 0
            imgs.append(h5.read_dataset(out, schema.IMG_DATASET))
        uvw0 = uvw_lambda(torch.tensor(vd.frequency, dtype=torch.float32),
                          torch.as_tensor(vd.uvw, dtype=torch.float32))
        nbins = [imaging.w_cache_bins(uvw0, s)[0].shape[0]
                 for s in (2000, 300)]
        assert nbins[1] > nbins[0]
        assert not np.array_equal(imgs[0], imgs[1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


class TestCuda:
    @pytest.mark.cuda
    @pytest.mark.parametrize("mode", ["conv", "wcache"])
    def test_do_imaging_launches_the_scatter_twice(self, cuda_device, obs_vd,
                                               mode):
        from ska_sdp_tpu_torch.kernels import wproj

        vd = obs_vd
        wproj.reset_launch_count()
        got = ds.psf_image(vd, mode, theta=THETA, lam=LAM,
                              device=cuda_device)
        assert wproj.launch_count(wproj.GRID_KERNEL) == 2
        want = ds.psf_image(vd, mode, theta=THETA, lam=LAM, device="cpu")
        assert _rel(got.image.cpu().numpy(), want.image.numpy()) < 1e-4
        assert _rel(got.psf.cpu().numpy(), want.psf.numpy()) < 1e-4
        # --precision double: the kernel computes in complex64 and refuses
        with pytest.raises(ValueError, match="complex64"):
            ds.psf_image(vd, mode, theta=THETA, lam=LAM,
                            precision="double", device=cuda_device)
