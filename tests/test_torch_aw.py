"""Port parity for the IDG-AW slice: A-kernel ingest, layout detection,
the IDG-AW imaging program, and the CLI's ``--mode aw --idg`` and
``--mode predict --idg [--aterms]`` surfaces.

* schema names byte-identical to the JAX package's, so each package reads
  the other's files; ``get_akernels`` against the JAX function on one file;
* ``_detect_time_major_layout`` against the JAX function;
* ``_aw_idg_pipeline`` (layout None and the detected raster) against the
  JAX ``_aw_idg_pipeline``, which grids through its XLA IDG-AW on the CPU:
  image rel-L2 ≤ 1e-4 over the central 75%;
* the port's CLI against the JAX CLI on one tiny dataset: images within
  1e-4 (central 75%), IDG-AW predictions within 5e-5, IDG predictions at
  method level (0.03: the JAX CLI degrids through its fixed-tile XLA
  realization on the CPU).
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ska_sdp_tpu.io import schema as j_schema  # noqa: E402
from ska_sdp_tpu.io import synthetic as j_synth  # noqa: E402
from ska_sdp_tpu.models import dataset as j_ds  # noqa: E402
from ska_sdp_tpu_torch import cli  # noqa: E402
from ska_sdp_tpu_torch.config import GridParams, ImagingConfig  # noqa: E402
from ska_sdp_tpu_torch.io import h5, schema  # noqa: E402
from ska_sdp_tpu_torch.io import synthetic  # noqa: E402
from ska_sdp_tpu_torch.models import dataset as ds  # noqa: E402
from ska_sdp_tpu_torch.ops.idg_aw import aw_screens_host  # noqa: E402

torch.set_num_threads(2)

THETA, LAM, N = 0.05, 5120, 256
GEO = ["--theta", str(THETA), "--lam", str(LAM)]


def _crop(a):
    n = a.shape[0]
    return a[n // 8:n - n // 8, n // 8:n - n // 8]


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("aw") / "obs")
    assert cli.main(["--make-data", d, "--nant", "10", "--ntime", "6",
                     *GEO]) == 0
    return d


@pytest.fixture(scope="module")
def observation():
    cfg = synthetic.SyntheticConfig(theta=THETA, lam=LAM, nant=10, ntime=12)
    obs = synthetic.simulate_observation(cfg)
    rng = np.random.default_rng(9)
    ak = np.zeros((10, 15, 15), np.complex128)
    ak[:, 7, 7] = 1.0
    ak += 0.05 * (rng.standard_normal(ak.shape)
                  + 1j * rng.standard_normal(ak.shape))
    return ds.vis_data_from_observation(obs), ak


class TestSchemaAndIngest:
    @pytest.mark.parametrize("x", [0.008, 0.05, 1.0, 55000.02, 1.65e8])
    def test_names_match_jax(self, x):
        assert schema.fmt_float(x) == j_schema.fmt_float(x)
        assert schema.akern_group(x) == j_schema.akern_group(x)
        assert (schema.akern_dataset(x, "3", "55000.0", "1.5e8")
                == j_schema.akern_dataset(x, "3", "55000.0", "1.5e8"))
        names = ["1.5e8", "1e3", "2", "0.5", schema.fmt_float(x)]
        assert schema.parse_sorted(names) == j_schema.parse_sorted(names)

    def test_get_akernels_matches_jax(self, tmp_path):
        cfg = synthetic.SyntheticConfig(theta=THETA, lam=LAM, nant=5,
                                        ntime=4)
        obs = synthetic.simulate_observation(cfg)
        jfile = str(tmp_path / "akern_jax.h5")
        tfile = str(tmp_path / "akern_torch.h5")
        j_synth.write_akern_file(jfile, obs, j_synth.SyntheticConfig(
            theta=THETA, lam=LAM, nant=5, ntime=4))
        synthetic.write_akern_file(tfile, obs, cfg)
        t0, f0 = float(obs["time"][0]), float(obs["frequency"][0])
        for t, f in ((t0, f0), (t0 + 0.019, 1.09 * f0), (t0 + 1.0, 0.0)):
            want = j_ds.get_akernels(jfile, THETA, t, f)
            assert want.shape == (5, 15, 15)
            np.testing.assert_array_equal(
                ds.get_akernels(jfile, THETA, t, f), want)
            # the port's writer writes the reference's file
            np.testing.assert_array_equal(
                ds.get_akernels(tfile, THETA, t, f), want)
        with pytest.raises(FileNotFoundError):
            ds.get_akernels(str(tmp_path / "missing.h5"), THETA, t0, f0)


class TestLayout:
    @pytest.mark.parametrize("case", ["raster", "one_time", "shuffled",
                                      "ragged"])
    def test_matches_jax(self, case, observation):
        vd = observation[0]
        a1, a2, t = vd.antenna1, vd.antenna2, vd.time
        n = a1.shape[0]
        if case == "one_time":
            n = 45
        elif case == "shuffled":
            perm = np.random.default_rng(1).permutation(n)
            a1, a2, t = a1[perm], a2[perm], t[perm]
        elif case == "ragged":
            n -= 7
        got = ds._detect_time_major_layout(a1, a2, t, n)
        assert got == j_ds._detect_time_major_layout(a1, a2, t, n)
        expect = {"raster": (12, 45), "one_time": (1, 45)}.get(case)
        assert got == expect


class TestAWPipeline:
    @pytest.mark.parametrize("raster", [False, True])
    def test_matches_jax_pipeline(self, observation, raster):
        vd, ak = observation
        n = vd.uvw.shape[0]
        a1 = np.asarray(vd.antenna1, np.int32)
        a2 = np.asarray(vd.antenna2, np.int32)
        layout = (ds._detect_time_major_layout(a1, a2, vd.time, n)
                  if raster else None)
        assert (layout is not None) == raster
        mr = ds._aw_run_bound(a1.astype(np.int64), a2.astype(np.int64), n)
        scr = aw_screens_host(ak.astype(np.complex64), 64).astype(
            np.complex64)
        uvw = np.asarray(vd.uvw, np.float32)
        f = np.asarray(vd.frequency, np.float32)
        vis = np.asarray(vd.vis, np.complex64)
        want, want_max, nd_want = j_ds._aw_idg_pipeline(
            scr, uvw, a1, a2, f, vis, theta=THETA, lam=LAM, max_runs=mr,
            layout=layout)
        got, got_max, nd = ds._aw_idg_pipeline(
            torch.as_tensor(scr), torch.as_tensor(uvw), torch.as_tensor(a1),
            torch.as_tensor(a2), torch.as_tensor(f), torch.as_tensor(vis),
            theta=THETA, lam=LAM, max_runs=mr, layout=layout)
        want = np.asarray(want)
        assert int(nd) == int(nd_want) == 0
        assert got.shape == want.shape == (N, N)
        assert _rel(_crop(got.numpy()), _crop(want)) < 1e-4
        # the full-image max may sit at the edge, where the taper division
        # amplifies rounding differently on each route: compare the
        # central max, and the returned max with the port's own image
        assert float(got_max) == float(got.max())
        assert float(want_max) == float(want.max())
        c_got, c_want = _crop(got.numpy()).max(), _crop(want).max()
        assert abs(c_got - c_want) < 1e-4 * abs(c_want)

    def test_entry_and_unported_routes(self, observation, data_dir):
        vd, ak = observation
        res = ds.aw_idg_image(vd, ak, theta=THETA, lam=LAM, device="cpu")
        assert res.n_dropped == 0
        assert res.image.shape == (N, N)
        assert np.isfinite(res.image.numpy()).all()
        # the file entry takes the reference's argument order; the fused
        # route (idg=False) reads the bank, the IDG-AW route needs none
        paths = [os.path.join(data_dir, f)
                 for f in ("wkern.h5", "akern.h5", "vis.h5")]
        cfg = ImagingConfig(grid=GridParams(theta=THETA, lam=LAM))
        mx_f, img_f = ds.aw_gridding(*paths, config=cfg, device="cpu")
        mx_i, img_i = ds.aw_gridding(None, *paths[1:], config=cfg, idg=True,
                                     device="cpu")
        for mx, img in ((mx_f, img_f), (mx_i, img_i)):
            assert img.shape == (N, N) and np.isfinite(img).all()
            assert mx == pytest.approx(float(img.max()))
        assert not np.array_equal(img_f, img_i)
        with pytest.raises(NotImplementedError, match="device_phases"):
            ds.aw_gridding(None, "a.h5", "v.h5", idg=True,
                           device_phases=True, device="cpu")


class TestCLI:
    def test_make_data_writes_vis_and_akern(self, data_dir):
        assert sorted(os.listdir(data_dir)) == ["akern.h5", "vis.h5",
                                                "wkern.h5"]
        ak = ds.get_akernels(os.path.join(data_dir, "akern.h5"), THETA,
                             55000.0, 1.5e8)
        np.testing.assert_array_equal(
            ak, j_ds.get_akernels(os.path.join(data_dir, "akern.h5"), THETA,
                                  55000.0, 1.5e8))
        assert ak.shape == (10, 15, 15)

    def test_aw_idg_and_predict_match_jax_cli(self, data_dir, tmp_path):
        from ska_sdp_tpu import cli as j_cli

        out = {}
        model = str(tmp_path / "model.h5")
        for name, main, dev in (("t", cli.main, ["--device", "cpu"]),
                                ("j", j_cli.main, ["--backend", "cpu"])):
            img = str(tmp_path / f"{name}_aw.h5")
            assert main(["--mode", "aw", "--idg", "-i", data_dir, "--all",
                         "-o", img, *dev, *GEO]) == 0
            out[name, "img"] = h5.read_dataset(img, "/img")
            if name == "t":
                # one model for both: the port's image inside the central
                # 75% (outside it the taper division leaves edge noise
                # that no prediction should be asked to reproduce)
                m = np.zeros_like(out[name, "img"])
                _crop(m)[...] = _crop(out[name, "img"])
                h5.create_file(model)
                h5.write_dataset(model, "/img", m)
            for tag, extra in (("idg", []), ("aterms", ["--aterms"])):
                pred = str(tmp_path / f"{name}_{tag}.h5")
                assert main(["--mode", "predict", "--idg", *extra, "-i",
                             data_dir, "--all", "--model", model, "-o", pred,
                             *dev, *GEO]) == 0
                out[name, tag] = h5.read_dataset(pred, "/vis/model")
        assert out["t", "img"].shape == (N, N)
        assert out["t", "img"].dtype == np.float64
        assert _rel(_crop(out["t", "img"]), _crop(out["j", "img"])) < 1e-4
        assert out["t", "aterms"].dtype == np.complex128
        assert _rel(out["t", "aterms"], out["j", "aterms"]) < 5e-5
        assert _rel(out["t", "idg"], out["j", "idg"]) < 0.03

    @pytest.mark.parametrize("argv,rc,msg", [
        (["--mode", "predict", "--idg"], 1, "requires --model"),
        (["--mode", "idg", "--aterms"], 1, "--aterms requires"),
        (["--mode", "predict", "--model", "m.h5", "--channels", "4"], 2,
         "not yet ported"),
        (["--mode", "aw", "--idg", "-i", "nowhere"], 1,
         "input file not found"),
        (["--mode", "predict", "--model", "m.h5", "-i", "nowhere"], 1,
         "input file not found"),
    ])
    def test_error_surfaces(self, argv, rc, msg, capsys):
        assert cli.main(argv) == rc
        assert msg in capsys.readouterr().err
