"""Port parity for the bank w-projection slice as a whole: ingest, imaging
(``--mode w``) and prediction (``--mode predict`` without ``--idg``).

On one ``generate_dataset`` bundle at the reference's end-to-end test size
(θ=0.05, lam=3600: a 180² grid; 8 stations, 6 times, 8 w-planes, qpx=4):

* the port's ``vis.h5``, ``wkern.h5`` and ``akern.h5`` carry the dataset
  names and values of the JAX writer's, to 1e-12;
* ``w_gridding`` and ``w_image`` (precision ``double``, on the CPU) match
  JAX ``w_gridding`` to 1e-8 of the image max, and the sources reappear;
* ``w_predict`` matches JAX ``w_predict`` to 1e-8 of the peak;
* the CLI's ``--mode w`` and ``--mode predict`` print what the JAX CLI
  prints, and the flags and modes not ported yet exit with status 2.
"""

import os
import re

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch import cli
from ska_sdp_tpu_torch.config import GridParams, ImagingConfig
from ska_sdp_tpu_torch.io import h5, inputs, schema
from ska_sdp_tpu_torch.io.synthetic import (SyntheticConfig, generate_dataset,
                                            simulate_observation,
                                            w_plane_centers)
from ska_sdp_tpu_torch.models import dataset as ds
from ska_sdp_tpu_torch.models import runs

jax = pytest.importorskip("jax")

from ska_sdp_tpu import config as j_config  # noqa: E402
from ska_sdp_tpu.io import schema as j_schema  # noqa: E402
from ska_sdp_tpu.io import synthetic as j_synthetic  # noqa: E402
from ska_sdp_tpu.models import dataset as j_ds  # noqa: E402

torch.set_num_threads(2)

CFG = dict(theta=0.05, lam=3600, nant=8, ntime=6, nsources=3, nw_planes=8,
           qpx=4, npix_ff=128, npix_kern=15, seed=7)
THETA, LAM, N = 0.05, 3600, 180
GEO = ["--theta", str(THETA), "--lam", str(LAM)]


def _h5_tree(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The same bundle written by the port and by the JAX package."""
    port = generate_dataset(str(tmp_path_factory.mktemp("port")),
                            SyntheticConfig(**CFG))
    ref = j_synthetic.generate_dataset(str(tmp_path_factory.mktemp("jax")),
                                       j_synthetic.SyntheticConfig(**CFG))
    return port, ref


@pytest.fixture(scope="module")
def double():
    return (ImagingConfig(grid=GridParams(theta=THETA, lam=LAM),
                          precision_name="double"),
            j_config.ImagingConfig(grid=j_config.GridParams(theta=THETA,
                                                            lam=LAM),
                                   precision_name="double"))


@pytest.fixture(scope="module")
def jax_image(bundles, double):
    (paths, _), _ = bundles
    return j_ds.w_gridding(paths["wkern"], paths["vis"], config=double[1])


class TestIngest:
    @pytest.mark.parametrize("kind", ["vis", "wkern", "akern"])
    def test_files_match_jax_writer(self, bundles, kind):
        (paths, _), (ref_paths, _) = bundles
        got, want = _h5_tree(paths[kind]), _h5_tree(ref_paths[kind])
        assert sorted(got) == sorted(want)
        for name, arr in want.items():
            assert got[name].shape == arr.shape and got[name].dtype == arr.dtype
            np.testing.assert_allclose(got[name], arr, rtol=1e-12, atol=0)

    def test_get_wkernels_matches_jax(self, bundles):
        (paths, obs), (ref_paths, _) = bundles
        bank, centers = inputs.get_wkernels(paths["wkern"], THETA)
        j_bank, j_centers = j_ds.get_wkernels(ref_paths["wkern"], THETA)
        assert bank.shape == (8, 4, 4, 15, 15) and bank.dtype == np.complex128
        np.testing.assert_allclose(bank, j_bank, rtol=1e-12, atol=1e-15)
        np.testing.assert_array_equal(centers, j_centers)
        np.testing.assert_allclose(
            centers, w_plane_centers(obs, SyntheticConfig(**CFG)), rtol=1e-15)

    @pytest.mark.parametrize("theta", [0.008, 0.05, 1.0])
    def test_schema_names(self, theta):
        assert schema.wkern_group(theta) == j_schema.wkern_group(theta)
        assert (schema.wkern_dataset(theta, "-12.5")
                == j_schema.wkern_dataset(theta, "-12.5"))

    def test_missing_bank_file(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="does not exist"):
            inputs.get_wkernels(str(tmp_path / "nowhere.h5"), THETA)


class TestWImaging:
    def test_w_gridding_matches_jax(self, bundles, double, jax_image):
        (paths, _), _ = bundles
        want_mx, want = jax_image
        mx, img = runs.w_gridding(paths["wkern"], paths["vis"],
                                  config=double[0], device="cpu")
        assert img.shape == want.shape == (N, N)
        scale = np.abs(want).max()
        np.testing.assert_allclose(img, want, atol=1e-8 * scale, rtol=0)
        assert abs(mx - want_mx) < 1e-8 * abs(want_mx)

    @pytest.mark.parametrize("n", [None, 100])
    def test_w_image_matches_jax(self, bundles, double, n):
        (paths, _), _ = bundles
        _, want = j_ds.w_gridding(paths["wkern"], paths["vis"], n=n,
                                  config=double[1])
        vd = inputs.load_vis_data(paths["vis"])
        bank, centers = inputs.get_wkernels(paths["wkern"], THETA)
        res = ds.w_image(vd, bank, centers, theta=THETA, lam=LAM, n=n,
                         precision="double", device="cpu")
        got = res.image.numpy()
        assert res.image.dtype == torch.float64
        np.testing.assert_allclose(got, want, atol=1e-8 * np.abs(want).max(),
                                   rtol=0)
        assert res.image_max == pytest.approx(float(got.max()))

    def test_sources_recovered(self, bundles, double):
        (paths, obs), _ = bundles
        _, img = runs.w_gridding(paths["wkern"], paths["vis"],
                                 config=double[0], device="cpu")
        for l, m, flux in obs["sources"]:
            iy = int(round(N / 2 + m * LAM))
            ix = int(round(N / 2 + l * LAM))
            window = img[max(0, iy - 2):iy + 3, max(0, ix - 2):ix + 3]
            assert window.max() > 0.25 * img.max(), (l, m, flux)
        iy, ix = np.unravel_index(np.argmax(img), img.shape)
        dists = [abs(iy - (N / 2 + m * LAM)) + abs(ix - (N / 2 + l * LAM))
                 for l, m, _ in obs["sources"]]
        assert min(dists) <= 3.0

    def test_single_precision_tracks_double(self, bundles, jax_image):
        (paths, _), _ = bundles
        vd = inputs.load_vis_data(paths["vis"])
        bank, centers = inputs.get_wkernels(paths["wkern"], THETA)
        res = ds.w_image(vd, bank, centers, theta=THETA, lam=LAM,
                         device="cpu")
        want = jax_image[1]
        assert res.image.dtype == torch.float32
        np.testing.assert_allclose(res.image.numpy(), want,
                                   atol=1e-5 * np.abs(want).max(), rtol=0)


class TestWPredict:
    def test_w_predict_matches_jax(self, bundles, double, jax_image,
                                   tmp_path):
        (paths, _), _ = bundles
        model = str(tmp_path / "model.h5")
        h5.create_file(model)
        h5.write_dataset(model, schema.IMG_DATASET, jax_image[1])
        want, want_peak = j_ds.w_predict(paths["wkern"], paths["vis"], model,
                                         config=double[1])
        out = str(tmp_path / "pred.h5")
        pred, peak = runs.w_predict(paths["wkern"], paths["vis"], model,
                                    outfile=out, config=double[0],
                                    device="cpu")
        assert pred.shape == want.shape and pred.dtype == np.complex128
        np.testing.assert_allclose(pred, want, atol=1e-8 * want_peak, rtol=0)
        assert abs(peak - want_peak) < 1e-8 * want_peak
        np.testing.assert_array_equal(
            h5.read_dataset(out, schema.MODEL_VIS_DATASET), pred)

    def test_model_shape_must_match_grid(self, bundles, double):
        (paths, _), _ = bundles
        vd = inputs.load_vis_data(paths["vis"])
        bank, centers = inputs.get_wkernels(paths["wkern"], THETA)
        with pytest.raises(ValueError, match="does not match grid"):
            ds.w_predict_vis(vd, bank, centers, np.zeros((N + 1, N + 1)),
                             theta=THETA, lam=LAM, device="cpu")


def _number(text: str, prefix: str) -> float:
    line = [ln for ln in text.splitlines() if ln.startswith(prefix)][-1]
    return float(re.findall(r"[-+0-9.e]+$", line)[0])


class TestCLI:
    @pytest.mark.parametrize("mode,prefix", [
        ("w", "image max: "),
        ("predict", "predicted 168 visibilities, peak |vis|: "),
    ])
    def test_prints_what_the_jax_cli_prints(self, bundles, mode, prefix,
                                            tmp_path, capsys):
        from ska_sdp_tpu import cli as j_cli

        (paths, _), _ = bundles
        data = os.path.dirname(paths["vis"])
        model = str(tmp_path / "model.h5")
        assert cli.main(["--mode", "w", "-i", data, "--all", "-o", model,
                         "--device", "cpu", "--precision", "double",
                         *GEO]) == 0
        extra = ["--model", model] if mode == "predict" else []
        capsys.readouterr()
        assert cli.main(["--mode", mode, "-i", data, "--all", *extra,
                         "--device", "cpu", "--precision", "double",
                         *GEO]) == 0
        got = capsys.readouterr().out
        assert j_cli.main(["--mode", mode, "-i", data, "--all", *extra,
                           "--backend", "cpu", "--precision", "double",
                           *GEO]) == 0
        want = capsys.readouterr().out
        assert _number(got, prefix) == pytest.approx(_number(want, prefix),
                                                     rel=1e-8)

    def test_make_data_writes_the_bank(self, tmp_path, capsys):
        data = str(tmp_path / "obs")
        assert cli.main(["--make-data", data, "--nant", "6", "--ntime", "4",
                         "--nw", "5", "--qpx", "2", *GEO]) == 0
        assert "wkern.h5" in capsys.readouterr().out
        bank, centers = inputs.get_wkernels(os.path.join(data, "wkern.h5"),
                                            THETA)
        assert bank.shape == (5, 2, 2, 15, 15) and centers.shape == (5,)

    @pytest.mark.parametrize("mode", [["--mode", "w"],
                                      ["--mode", "predict", "--model",
                                       "m.h5"]])
    def test_missing_bank_is_reported(self, tmp_path, mode, capsys):
        obs = simulate_observation(SyntheticConfig(theta=THETA, lam=LAM,
                                                   nant=4, ntime=2))
        from ska_sdp_tpu_torch.io.synthetic import write_vis_file

        write_vis_file(str(tmp_path / "vis.h5"), obs)
        assert cli.main([*mode, "-i", str(tmp_path), "--device", "cpu",
                         *GEO]) == 1
        err = capsys.readouterr().err
        assert f"input file not found: {tmp_path / 'wkern.h5'}" in err

    @pytest.mark.parametrize("argv", [
        ["--mode", "w", "--gridder", "pallas"],
        ["--mode", "w", "--gridder", "xla"],
        ["--mode", "w", "--backend", "tpu"],
        ["--mode", "w", "--xla-dump", "dump"],
        ["--mode", "wcache", "--backend", "tpu"],
        ["--mode", "conv", "--xla-dump", "dump"],
        ["--mode", "simple", "--gridder", "auto"],
    ])
    def test_unported_surfaces_exit_2(self, argv, capsys):
        assert cli.main(argv) == 2
        assert "not yet ported" in capsys.readouterr().err

