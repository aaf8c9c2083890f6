"""Port parity for the staged drivers (``--device-phases`` on ``--mode w``,
``aw`` and ``aw --idg``) and the ``--dump-intermediates`` tree.

On one ``generate_dataset`` bundle (θ=0.05, lam=3600: a 180² grid; 8
stations, 6 times, 8 w-planes, qpx=4), on the CPU through the kernels'
plain versions:

* each staged file entry against the port's own unstaged entry, precision
  ``double``: within 1e-10 of the image peak (IDG-AW: against the unstaged
  program with the run prep's sort, which the staged route takes, and
  within 1e-4 rel-L2 over the central 75% of the entry, which grids the
  raster unsorted), with the stage times in the timer and the same
  ``idg_aw/dropped`` counter;
* each staged entry against the JAX package's staged entry: w within
  1e-8 of the peak, fused AW within 1e-8 rel-L2, IDG-AW (``fov_pad=0.75``)
  within 1e-4 rel-L2 over the central 75% with equal ``n_dropped``;
* the ``/debug`` tree of ``--dump-intermediates`` has the JAX CLI's names,
  shapes and dtypes, and its image is the run's.

The ``cuda`` cases run the staged entries on the card: each stage
launches its CUDA kernel, and the images are within 1e-5 of the unstaged
entries on the card.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch import cli
from ska_sdp_tpu_torch.config import GridParams, ImagingConfig
from ska_sdp_tpu_torch.io import inputs
from ska_sdp_tpu_torch.io.synthetic import SyntheticConfig, generate_dataset
from ska_sdp_tpu_torch.models import dataset as ds
from ska_sdp_tpu_torch.models import runs
from ska_sdp_tpu_torch.utils.timing import PhaseTimer

torch.set_num_threads(2)

THETA, LAM, N = 0.05, 3600, 180
CFG = dict(theta=THETA, lam=LAM, nant=8, ntime=6, nsources=3, nw_planes=8,
           qpx=4, npix_ff=128, npix_kern=15, seed=7)
GEO = ["--theta", str(THETA), "--lam", str(LAM)]
STAGES = {
    "w": ("dispatch-floor", "preprocess", "scatter", "hermitian+ifft"),
    "aw": ("dispatch-floor", "preprocess", "aw-fused-kernel",
           "hermitian+ifft"),
    "aw_idg": ("dispatch-floor", "preprocess", "run-sort", "idg-aw-kernel",
               "hermitian+ifft+taper"),
}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _crop(a):
    n = a.shape[0]
    return a[n // 8:n - n // 8, n // 8:n - n // 8]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("staged")),
                            SyntheticConfig(**CFG))[0]


def _config(precision="double"):
    return ImagingConfig(grid=GridParams(theta=THETA, lam=LAM),
                         precision_name=precision)


def _run(paths, kind, device_phases, device="cpu", precision="double"):
    """``(image max, image, timer)`` of a file entry."""
    timer = PhaseTimer()
    kw = dict(config=_config(precision), timer=timer,
              device_phases=device_phases, device=device)
    if kind == "w":
        mx, img = runs.w_gridding(paths["wkern"], paths["vis"], **kw)
    elif kind == "aw":
        mx, img = runs.aw_gridding(paths["wkern"], paths["akern"],
                                   paths["vis"], **kw)
    else:
        mx, img = runs.aw_gridding(None, paths["akern"], paths["vis"],
                                   idg=True, fov_pad=0.75, **kw)
    return mx, img, timer


@pytest.fixture(scope="module")
def j():
    pytest.importorskip("jax")
    from ska_sdp_tpu import cli as j_cli
    from ska_sdp_tpu import config as j_config
    from ska_sdp_tpu.models import dataset as j_ds
    from ska_sdp_tpu.utils.timing import PhaseTimer as JTimer

    cfg = j_config.ImagingConfig(
        grid=j_config.GridParams(theta=THETA, lam=LAM),
        precision_name="double")
    return SimpleNamespace(cli=j_cli, ds=j_ds, cfg=cfg, Timer=JTimer)


def _aw_idg_sorted(paths):
    """The unstaged IDG-AW program on the file's records with the run
    prep's sort (no raster shortcut), as the staged route grids them."""
    from ska_sdp_tpu_torch.types import DOUBLE

    vd = inputs.load_vis_data(paths["vis"])
    ak = inputs.get_akernels(paths["akern"], THETA, float(vd.time[0]),
                             vd.frequency)
    n = vd.vis.shape[0]
    a1, a2 = ds.ant_ids(vd, n)
    uvw, f, vis = ds.idg_inputs(vd, precision="double", device="cpu")
    img, _, _ = ds.aw_idg_pipeline(
        ds.antenna_screens(ak, 64, THETA, LAM, 0.75, DOUBLE, "cpu"), uvw,
        torch.as_tensor(a1.astype(np.int32)),
        torch.as_tensor(a2.astype(np.int32)), f, vis, theta=THETA, lam=LAM,
        max_runs=ds.aw_run_bound(a1, a2, n), fov_pad=0.75)
    return img.numpy()


class TestStagedMatchesUnstaged:
    @pytest.mark.parametrize("kind", ["w", "aw", "aw_idg"])
    def test_same_image_and_stage_times(self, paths, kind):
        mx_p, img_p, t_p = _run(paths, kind, False)
        mx_s, img_s, t_s = _run(paths, kind, True)
        assert img_s.shape == img_p.shape and img_s.dtype == np.float64
        scale = np.abs(img_p).max()
        if kind == "aw_idg":
            # the unstaged entry grids the file's time-major raster without
            # a sort, whose runs (and so subgrid placements) differ from
            # the sorted runs the staged route grids: the IDG-AW image
            # bound holds against it, 1e-10 against the sorted program
            assert _rel(_crop(img_s), _crop(img_p)) <= 1e-4
            img_p = _aw_idg_sorted(paths)
        np.testing.assert_allclose(img_s, img_p, atol=1e-10 * scale, rtol=0)
        assert abs(mx_s - img_p.max()) < 1e-10 * scale
        for stage in STAGES[kind]:
            assert f"device/{stage}" in t_s.times, (stage, t_s.times)
        assert not any(k.startswith("device/") for k in t_p.times)
        assert "h2d+compile+grid+fft" in t_p.times
        if kind == "aw_idg":
            assert (t_s.counters["idg_aw/dropped"]
                    == t_p.counters["idg_aw/dropped"])


class TestStagedMatchesJax:
    @pytest.mark.parametrize("kind", ["w", "aw", "aw_idg"])
    def test_matches_jax_staged(self, paths, j, kind):
        jt = j.Timer()
        if kind == "w":
            want_mx, want = j.ds.w_gridding(paths["wkern"], paths["vis"],
                                            config=j.cfg, timer=jt,
                                            device_phases=True)
        elif kind == "aw":
            want_mx, want = j.ds.aw_gridding(
                paths["wkern"], paths["akern"], paths["vis"], config=j.cfg,
                timer=jt, device_phases=True)
        else:
            want_mx, want = j.ds.aw_gridding(
                paths["wkern"], paths["akern"], paths["vis"], config=j.cfg,
                timer=jt, idg=True, fov_pad=0.75, device_phases=True)
        mx, got, timer = _run(paths, kind, True)
        assert got.shape == want.shape
        # the reference's phase names; on the CPU its IDG-AW stages are
        # its XLA route's
        phases = [k for k in timer.times if not k.startswith("device/")]
        assert phases == [k for k in jt.times if not k.startswith("device/")]
        if kind != "aw_idg":
            assert list(timer.times) == list(jt.times)
        scale = np.abs(want).max()
        if kind == "w":
            np.testing.assert_allclose(got, want, atol=1e-8 * scale, rtol=0)
            assert abs(mx - want_mx) < 1e-8 * scale
        elif kind == "aw":
            assert _rel(got, want) <= 1e-8
            assert abs(mx - want_mx) <= 1e-8 * abs(want_mx)
        else:
            assert _rel(_crop(got), _crop(want)) <= 1e-4
            assert (timer.counters["idg_aw/dropped"]
                    == jt.counters["idg_aw/dropped"])


class TestDumpIntermediates:
    def test_debug_tree_matches_jax_cli(self, paths, j, tmp_path):
        import h5py

        d = os.path.dirname(paths["vis"])
        got_f, want_f = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
        assert cli.main(["--mode", "w", "-i", d, "--all", "--device", "cpu",
                         "--dump-intermediates", got_f, *GEO]) == 0
        assert j.cli.main(["--mode", "w", "-i", d, "--all", "--backend",
                           "cpu", "--dump-intermediates", want_f,
                           *GEO]) == 0

        def tree(path):
            out = {}
            with h5py.File(path, "r") as f:
                f.visititems(lambda k, v: out.__setitem__(k, v[()])
                             if isinstance(v, h5py.Dataset) else None)
            return out

        got, want = tree(got_f), tree(want_f)
        assert sorted(got) == sorted(want) == [
            "debug/img", "debug/uvgrid_im", "debug/uvgrid_re", "debug/wbin"]
        for k in want:
            assert got[k].shape == want[k].shape and \
                got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got["debug/wbin"], want["debug/wbin"])
        for k in ("debug/img", "debug/uvgrid_re", "debug/uvgrid_im"):
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=1e-5 * np.abs(want[k]).max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def memory_case():
    """The bundle's observation, bank and A-kernels in memory (the card's
    machine has no h5py)."""
    from ska_sdp_tpu_torch.io import synthetic

    cfg = SyntheticConfig(**CFG)
    obs = synthetic.simulate_observation(cfg)
    centers = synthetic.w_plane_centers(obs, cfg)
    bank = np.stack([synthetic.w_kernel_host(THETA, float(w), 4, 128, 15)
                     for w in centers])
    return SimpleNamespace(vd=inputs.vis_data_from_observation(obs), bank=bank,
                           centers=centers,
                           ak=synthetic.akern_stamps(cfg)[:, 0, 0])


def _staged_on(m, kind, dev, timer):
    """The staged program of ``kind`` on ``dev`` (single precision) and
    its unstaged in-memory entry: ``(staged image, entry image)``."""
    from ska_sdp_tpu_torch.types import SINGLE

    kw = dict(theta=THETA, lam=LAM, device=dev)
    uvw, f, vis = ds.idg_inputs(m.vd, device=dev)
    bank, wb = ds.bank_tensors(m.bank, m.centers, SINGLE, dev)
    a1, a2 = (torch.as_tensor(a.astype(np.int32), device=dev)
              for a in (m.vd.antenna1, m.vd.antenna2))
    if kind == "w":
        got = runs.wproj_staged(torch.conj(bank).resolve_conj(), wb, uvw, f,
                                vis, theta=THETA, lam=LAM, chunk=8192,
                                timer=timer)
        want = ds.w_image(m.vd, m.bank, m.centers, **kw)
    elif kind == "aw":
        got = runs.aw_fused_staged(
            bank, wb, torch.as_tensor(m.ak, dtype=torch.complex64,
                                      device=dev),
            uvw, a1, a2, f, vis, theta=THETA, lam=LAM, chunk=8192,
            timer=timer)
        want = ds.aw_image(m.vd, m.bank, m.centers, m.ak, **kw)
    else:
        n = vis.shape[0]
        got = runs.aw_idg_staged(
            ds.antenna_screens(m.ak, 64, THETA, LAM, 0.75, SINGLE, dev), uvw,
            a1, a2, f, vis, theta=THETA, lam=LAM, subgrid=64,
            taper_beta=12.0, timer=timer, fov_pad=0.75,
            max_runs=ds.aw_run_bound(m.vd.antenna1, m.vd.antenna2, n))
        want = ds.aw_idg_image(m.vd, m.ak, fov_pad=0.75, **kw)
    return got[0].cpu().numpy(), want.image.cpu().numpy()


class TestCuda:
    @pytest.mark.cuda
    @pytest.mark.parametrize("kind", ["w", "aw", "aw_idg"])
    def test_stages_launch_the_kernels(self, memory_case, cuda_device,
                                       kind):
        from ska_sdp_tpu_torch.kernels import aw_fused, wproj
        from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream

        mod, name = {"w": (wproj, wproj.GRID_KERNEL),
                     "aw": (aw_fused, aw_fused.GRID_KERNEL),
                     "aw_idg": (stream, stream.GRID_KERNEL)}[kind]
        timer = PhaseTimer()
        mod.reset_launch_count()
        got, want = _staged_on(memory_case, kind, cuda_device, timer)
        # the warm-up and the timed call of the kernel stage, and the entry
        assert mod.launch_count(name) == 3
        if kind == "aw_idg":
            got, want = _crop(got), _crop(want)
        assert _rel(got, want) < 1e-5
        for stage in STAGES[kind]:
            assert f"device/{stage}" in timer.times
