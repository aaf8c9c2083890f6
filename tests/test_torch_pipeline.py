"""Port parity for the ``--mode idg`` imaging slice as a whole.

* the port's ``idg_pipeline`` against the JAX ``_idg_pipeline`` on the
  same synthetic observation (the JAX side grids through its XLA IDG on
  the CPU, another route to the same operator): image rel-L2 ≤ 1e-4 over
  the central 75%;
* the port's gridder against a direct-DFT truth image: ≤ 3e-4, the bound
  the reference's IDG accuracy test uses;
* the port's CLI (``--make-data`` + ``--mode idg``) against the JAX CLI's
  ``/img`` on one tiny dataset;
* importing the port's CLI loads neither jax nor h5py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ska_sdp_tpu.models.dataset import _idg_pipeline as j_pipeline  # noqa: E402,E501
from ska_sdp_tpu_torch import kernels  # noqa: E402
from ska_sdp_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticConfig, simulate_observation)
from ska_sdp_tpu_torch.io.inputs import vis_data_from_observation  # noqa: E402,E501
from ska_sdp_tpu_torch.models.dataset import idg_image  # noqa: E402
from ska_sdp_tpu_torch.ops import ifft_centered  # noqa: E402
from ska_sdp_tpu_torch.ops.idg import kaiser_taper, taper_fine  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THETA, LAM = 0.05, 5120          # a 256² grid
N = 256


def _crop(a):
    n = a.shape[0]
    return a[n // 8:n - n // 8, n // 8:n - n // 8]


def _rel(a, b):
    return np.linalg.norm(_crop(a - b)) / np.linalg.norm(_crop(b))


@pytest.fixture(scope="module")
def observation():
    return simulate_observation(SyntheticConfig(theta=THETA, lam=LAM,
                                                nant=16, ntime=24))


class TestPipeline:
    @pytest.mark.parametrize("fov_pad", [None, 0.75])
    def test_matches_jax_pipeline(self, observation, fov_pad):
        vd = vis_data_from_observation(observation)
        want, want_max = j_pipeline(
            np.asarray(vd.uvw, np.float32),
            np.asarray(vd.frequency, np.float32),
            np.asarray(vd.vis, np.complex64), theta=THETA, lam=LAM,
            subgrid=64, taper_beta=12.0, fov_pad=fov_pad)
        want = np.asarray(want)
        res = idg_image(vd, theta=THETA, lam=LAM, subgrid=64,
                        fov_pad=fov_pad, device="cpu")
        got = res.image.numpy()
        assert got.shape == want.shape == (N, N)
        assert res.n_dropped == 0
        assert _rel(got, want) < 1e-4
        assert abs(res.image_max - float(want_max)) < 1e-4 * abs(want_max)

    def test_sources_recovered(self, observation):
        res = idg_image(vis_data_from_observation(observation), theta=THETA,
                        lam=LAM, device="cpu")
        img = res.image.numpy()
        assert np.isfinite(img).all()
        iy, ix = np.unravel_index(np.argmax(img), img.shape)
        dists = [abs(iy - (N / 2 + m * LAM)) + abs(ix - (N / 2 + l * LAM))
                 for l, m, _ in observation["sources"]]
        assert min(dists) <= 3.0
        for l, m, _ in observation["sources"]:
            cy, cx = int(round(N / 2 + m * LAM)), int(round(N / 2 + l * LAM))
            win = img[max(0, cy - 2):cy + 3, max(0, cx - 2):cx + 3]
            assert win.max() > 0.25 * img.max()

    def test_gridder_matches_direct_dft_truth(self):
        rng = np.random.default_rng(41)
        b, S, wmax = 300, 64, 250.0
        p = rng.uniform(-0.42, 0.42, (b, 3)).astype(np.float32)
        w = rng.uniform(-wmax, wmax, b).astype(np.float32)
        vis = (rng.standard_normal(b) + 1j * rng.standard_normal(b)
               ).astype(np.complex64)
        guv, nd = kernels.idg_gridder(
            (N, N), torch.as_tensor(p), torch.as_tensor(w),
            torch.as_tensor(vis), theta=THETA, subgrid=S)
        assert int(nd) == 0
        tf = taper_fine(N, S, kaiser_taper(S, 12.0)).numpy()
        img = ifft_centered(guv).numpy() / np.outer(tf, tf)

        xf = (np.arange(N) - N // 2) / N
        lm = xf * THETA
        L, M = np.meshgrid(lm, lm, indexing="xy")
        n_lm = 1.0 - np.sqrt(1.0 - L**2 - M**2)
        ey = np.exp(2j * np.pi * p[:, 1, None].astype(np.float64) * N * xf)
        ex = np.exp(2j * np.pi * p[:, 0, None].astype(np.float64) * N * xf)
        truth = np.einsum("b,by,bx,byx->yx", vis.astype(np.complex128), ey,
                          ex, np.exp(-2j * np.pi * w[:, None, None]
                                     .astype(np.float64) * n_lm))
        assert _rel(img, truth / (N * N)) < 3e-4


class TestCLI:
    def test_cli_matches_jax_cli(self, tmp_path):
        from ska_sdp_tpu import cli as j_cli
        from ska_sdp_tpu_torch import cli
        from ska_sdp_tpu_torch.io import h5

        data = str(tmp_path / "obs")
        geo = ["--theta", str(THETA), "--lam", str(LAM)]
        assert cli.main(["--make-data", data, "--nant", "10", "--ntime",
                         "6", *geo]) == 0
        assert os.path.exists(os.path.join(data, "vis.h5"))
        out_t = str(tmp_path / "torch.h5")
        out_j = str(tmp_path / "jax.h5")
        assert cli.main(["--mode", "idg", "-i", data, "--all", "-o", out_t,
                         "--device", "cpu", *geo]) == 0
        assert j_cli.main(["--mode", "idg", "-i", data, "--all", "-o",
                           out_j, "--backend", "cpu", *geo]) == 0
        got = h5.read_dataset(out_t, "/img")
        want = h5.read_dataset(out_j, "/img")
        assert got.shape == want.shape == (N, N)
        assert got.dtype == np.float64
        assert _rel(got, want) < 1e-4

    @pytest.mark.parametrize("argv", [["--xla-dump", "dump"],
                                      ["--gridder", "xla"],
                                      ["--gridder", "auto"],
                                      ["--backend", "tpu"]])
    def test_unported_surfaces_exit_cleanly(self, argv, capsys):
        from ska_sdp_tpu_torch import cli

        assert cli.main(argv) == 2
        assert "not yet ported" in capsys.readouterr().err

    def test_import_loads_no_jax(self):
        code = ("import sys, ska_sdp_tpu_torch.cli, "
                "ska_sdp_tpu_torch.models.dataset, "
                "ska_sdp_tpu_torch.models.spectral, "
                "ska_sdp_tpu_torch.utils.timing, "
                "ska_sdp_tpu_torch.kernels.idg_tile; "
                "bad = [m for m in ('jax', 'ska_sdp_tpu', 'h5py') "
                "if m in sys.modules]; "
                "assert not bad, bad")
        env = dict(os.environ, PYTHONPATH=REPO)
        subprocess.run([sys.executable, "-c", code], check=True, env=env,
                       cwd=REPO, timeout=120)
