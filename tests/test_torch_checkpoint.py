"""Port parity for the slab-wise ``--mode w`` runs and the run surfaces:
checkpoint and resume, the out-of-core (streamed) run, the checkpoint
guards, ``SlabPrefetcher``, ``MetricsSink`` and the CLI's new flags.

On ``--make-data`` observations at the reference's end-to-end size (θ=0.05,
lam=1600: an 80² grid; 8 stations, 6 times: 168 records; 4 w-planes,
qpx=2), on the CPU through the plain scatter:

* a checkpointed run stopped after one slab and resumed equals the port's
  one-shot ``w_gridding`` to rtol 1e-10 in double; the file is removed on
  success;
* a checkpoint written mid-run by the JAX package is resumed by the port,
  and one written by the port is resumed by the JAX package (each resumed
  run stops one slab later at the next slab boundary, so it did not
  restart), each giving the one-shot image to rtol 1e-10 in double; both
  packages write the same fingerprint in single and in double;
* the out-of-core run equals the JAX ``w_gridding_out_of_core`` (1e-8 of
  the peak in double, 1e-5 in single), on a file with a record whose u
  falls outside the grid while its v is inside, and its pass-1 histogram
  equals the reference's numpy histogram integer for integer;
* guards: another total, fingerprint or grid shape, or a corrupt file, is
  rejected with a warning under ``ska_sdp_tpu_torch.checkpoint``; a
  single-precision run writes float32 planes;
* ``SlabPrefetcher`` raises a reader's error and releases its thread on
  an early exit; ``MetricsSink`` writes one JSON object a line;
* the CLI prints what the JAX CLI prints for each new flag,
  ``--out-of-core`` without ``--checkpoint`` exits 1, ``--metrics``
  writes ``run/start`` and ``run/done`` with ``phases`` and ``counters``,
  and the flags still not ported exit 2.

The ``cuda`` cases run the in-memory slab loops on the card: four scatter
launches for four slabs, and a resumed run equal to the one-shot image.
"""

import json
import logging
import os
import re
import shutil
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch import cli
from ska_sdp_tpu_torch.config import GridParams, ImagingConfig
from ska_sdp_tpu_torch.io import h5, inputs, schema
from ska_sdp_tpu_torch.io.stream import SlabPrefetcher
from ska_sdp_tpu_torch.models import dataset as ds
from ska_sdp_tpu_torch.models import runs
from ska_sdp_tpu_torch.types import SPEED_OF_LIGHT
from ska_sdp_tpu_torch.utils import checkpoint as ckpt
from ska_sdp_tpu_torch.utils.metrics import MetricsSink
from ska_sdp_tpu_torch.utils.timing import PhaseTimer

torch.set_num_threads(2)

THETA, LAM, N = 0.05, 1600, 80
GEO = ["--theta", str(THETA), "--lam", str(LAM)]
SLAB = 64
LOG = "ska_sdp_tpu_torch.checkpoint"


def _config(precision="double"):
    return ImagingConfig(grid=GridParams(theta=THETA, lam=LAM),
                         precision_name=precision)


@pytest.fixture(scope="module")
def obs_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt") / "obs")
    assert cli.main(["--make-data", d, "--nant", "8", "--ntime", "6",
                     "--nw", "4", "--qpx", "2", *GEO]) == 0
    return d


@pytest.fixture(scope="module")
def files(obs_dir):
    return SimpleNamespace(wk=os.path.join(obs_dir, "wkern.h5"),
                           vis=os.path.join(obs_dir, "vis.h5"))


@pytest.fixture(scope="module")
def one_shot(files):
    return runs.w_gridding(files.wk, files.vis, config=_config(),
                           device="cpu")


@pytest.fixture(scope="module")
def j():
    pytest.importorskip("jax")
    from ska_sdp_tpu import cli as j_cli
    from ska_sdp_tpu import config as j_config
    from ska_sdp_tpu.models import dataset as j_ds
    from ska_sdp_tpu.utils import checkpoint as j_ckpt
    from ska_sdp_tpu.utils.oracle import frac_coord

    def cfg(precision="double"):
        return j_config.ImagingConfig(
            grid=j_config.GridParams(theta=THETA, lam=LAM),
            precision_name=precision)

    return SimpleNamespace(cli=j_cli, ds=j_ds, ckpt=j_ckpt, cfg=cfg,
                           frac_coord=frac_coord)


def _next(path):
    return int(h5.read_dataset(path, ckpt.NEXT)[0])


class TestCheckpointResume:
    def test_resume_matches_one_shot(self, files, one_shot, tmp_path):
        ck = str(tmp_path / "run.ckpt.h5")
        mx0, img0 = one_shot
        timer = PhaseTimer()
        assert runs.w_gridding_checkpointed(
            files.wk, files.vis, ck, slab=SLAB, config=_config(),
            _max_slabs=1, device="cpu", timer=timer) == (None, None)
        assert os.path.exists(ck) and _next(ck) == SLAB
        assert list(timer.times) == ["ingest/vis", "ingest/wkern",
                                     "grid/slab", "checkpoint/write"]
        out = str(tmp_path / "img.h5")
        mx, img = runs.w_gridding_checkpointed(
            files.wk, files.vis, ck, outfile=out, slab=SLAB,
            config=_config(), device="cpu", timer=timer)
        assert not os.path.exists(ck)
        np.testing.assert_allclose(img, img0, rtol=1e-10, atol=1e-12)
        assert abs(mx - mx0) < 1e-10
        np.testing.assert_array_equal(
            h5.read_dataset(out, schema.IMG_DATASET), img)
        assert list(timer.times)[-2:] == ["finish/fft", "write/img"]

    def test_in_memory_callback_and_resume(self, files, one_shot):
        vd = inputs.load_vis_data(files.vis)
        bank, centers = inputs.get_wkernels(files.wk, THETA)
        copies = []
        kw = dict(theta=THETA, lam=LAM, slab=SLAB, precision="double",
                  device="cpu")
        assert ds.w_image_slabs(
            vd, bank, centers, max_slabs=2, **kw,
            on_slab=lambda g, nxt: copies.append((g.clone(), nxt))) is None
        assert [nxt for _, nxt in copies] == [SLAB, 2 * SLAB]
        res = ds.w_image_slabs(vd, bank, centers, start=copies[-1][1],
                               grid=copies[-1][0].numpy(), **kw)
        np.testing.assert_allclose(res.image.numpy(), one_shot[1],
                                   rtol=1e-10, atol=1e-12)


class TestCrossPackageResume:
    @pytest.mark.parametrize("precision", ["single", "double"])
    def test_same_fingerprint(self, files, j, tmp_path, precision):
        paths = [str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")]
        j.ds.w_gridding_checkpointed(files.wk, files.vis, paths[0],
                                     slab=SLAB, config=j.cfg(precision),
                                     _max_slabs=1)
        runs.w_gridding_checkpointed(files.wk, files.vis, paths[1], slab=SLAB,
                                     config=_config(precision), _max_slabs=1,
                                     device="cpu")
        fprs = [int(h5.read_dataset(p, ckpt.FPR)[0]) for p in paths]
        assert fprs[0] == fprs[1] != 0
        real = np.float32 if precision == "single" else np.float64
        for p in paths:
            assert h5.read_dataset(p, ckpt.GRID_RE).dtype == real

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_resume_across_packages(self, files, one_shot, j, tmp_path,
                                    caplog, writer):
        ck = str(tmp_path / "x.ckpt.h5")
        first, second = ((j.ds, ds) if writer == "jax" else (ds, j.ds))

        def run(mod, **kw):
            if mod is ds:
                return runs.w_gridding_checkpointed(
                    files.wk, files.vis, ck, slab=SLAB, config=_config(),
                    device="cpu", **kw)
            return j.ds.w_gridding_checkpointed(
                files.wk, files.vis, ck, slab=SLAB, config=j.cfg(), **kw)

        with caplog.at_level(logging.WARNING):
            run(first, _max_slabs=1)
            assert _next(ck) == SLAB
            # one more slab by the other package: resumed, not restarted
            run(second, _max_slabs=1)
            assert _next(ck) == 2 * SLAB
            mx, img = run(second)
        assert not caplog.records
        assert not os.path.exists(ck)
        np.testing.assert_allclose(img, one_shot[1], rtol=1e-10, atol=1e-12)
        assert abs(mx - one_shot[0]) < 1e-10


def _reference_counts(uvw, freq, frac_coord):
    """The reference's pass-1 histogram (``w_gridding_out_of_core``), in
    numpy."""
    counts = np.zeros(N * N, np.int64)
    uvw_l = uvw * (freq / 299792458.0)
    x, _ = frac_coord(N, 1, uvw_l[:, 0] / LAM)
    y, _ = frac_coord(N, 1, uvw_l[:, 1] / LAM)
    flat = y * N + x
    inb = (flat >= 0) & (flat < N * N)
    np.add.at(counts, flat[inb], 1)
    counts[counts == 0] = 1
    return counts


@pytest.fixture(scope="module")
def wide_files(files, tmp_path_factory):
    """The observation with one record's u beyond the grid's edge and its
    v inside, and one far off the grid (a neighbouring-row wrap and a
    dropped cell in the reference's flat-index histogram)."""
    import h5py

    d = tmp_path_factory.mktemp("wide")
    vis = str(d / "vis.h5")
    shutil.copy(files.vis, vis)
    freq = float(h5.read_dataset(vis, schema.VIS_FREQUENCY).ravel()[0])
    m_per_cell = LAM / N * SPEED_OF_LIGHT / freq
    with h5py.File(vis, "r+") as f:
        uvw = f[schema.VIS_UVW]
        row = np.array(uvw[3])
        row[0] = (N // 2 + 3) * m_per_cell         # x = N + 3
        row[1] = 5.2 * m_per_cell
        uvw[3] = row
        uvw[7] = np.array([0.0, 3 * N * m_per_cell, 10.0])
    return SimpleNamespace(wk=files.wk, vis=vis, freq=freq)


class TestOutOfCore:
    def test_histogram_equals_reference(self, wide_files, j):
        uvw = h5.read_dataset(wide_files.vis, schema.VIS_UVW)
        got = ds.stream_weight_counts(
            lambda s, c: uvw[s:s + c], uvw.shape[0], wide_files.freq,
            theta=THETA, lam=LAM, slab=50, device="cpu")
        want = _reference_counts(uvw, wide_files.freq, j.frac_coord)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        # record 3 wraps into the next row and is counted, record 7 is
        # dropped
        uvw_l = uvw * (wide_files.freq / 299792458.0) / LAM
        x, _ = j.frac_coord(N, 1, uvw_l[:, 0])
        y, _ = j.frac_coord(N, 1, uvw_l[:, 1])
        assert x[3] >= N and 0 <= y[3] < N and y[3] * N + x[3] < N * N
        assert y[7] * N + x[7] >= N * N

    @pytest.mark.parametrize("precision,tol", [("double", 1e-8),
                                               ("single", 1e-5)])
    def test_matches_jax(self, wide_files, j, tmp_path, precision, tol):
        from ska_sdp_tpu.utils.timing import PhaseTimer as JTimer

        jt = JTimer()
        want_mx, want = j.ds.w_gridding_out_of_core(
            wide_files.wk, wide_files.vis, str(tmp_path / "j.h5"), slab=50,
            config=j.cfg(precision), timer=jt)
        ck = str(tmp_path / "p.h5")
        timer = PhaseTimer()
        mx, img = runs.w_gridding_out_of_core(
            wide_files.wk, wide_files.vis, ck, slab=50,
            config=_config(precision), device="cpu", timer=timer)
        assert not os.path.exists(ck)
        scale = np.abs(want).max()
        np.testing.assert_allclose(img, want, atol=tol * scale, rtol=0)
        assert abs(mx - want_mx) < tol * scale
        # the reference's phases, and the port's prefetch wait
        assert [k for k in timer.times if k != "stream/prefetch-wait"] == \
            list(jt.times) == ["ingest/wkern", "weight/histogram",
                               "grid/slab", "checkpoint/write", "finish/fft"]

    def test_resume(self, files, tmp_path):
        ck = str(tmp_path / "ooc.h5")
        kw = dict(slab=SLAB, config=_config(), device="cpu")
        want = runs.w_gridding_out_of_core(files.wk, files.vis,
                                           str(tmp_path / "w.h5"), **kw)
        assert runs.w_gridding_out_of_core(files.wk, files.vis, ck,
                                           _max_slabs=1, **kw) == (None, None)
        assert _next(ck) == SLAB
        mx, img = runs.w_gridding_out_of_core(files.wk, files.vis, ck, **kw)
        np.testing.assert_allclose(img, want[1], rtol=1e-10, atol=1e-12)

    def test_multichannel_reads_channel_zero(self, tmp_path):
        d = str(tmp_path / "cube")
        assert cli.main(["--make-data", d, "--nant", "6", "--ntime", "4",
                         "--nw", "4", "--qpx", "2", "--nchan", "3",
                         *GEO]) == 0
        vis = os.path.join(d, "vis.h5")
        total, per_row, nch = inputs.vis_record_geometry(vis)
        vd = inputs.load_vis_data(vis)
        assert (total, nch) == (vd.vis.shape[0], 3)
        read = inputs.flat_vis_reader(vis, per_row, nch)
        np.testing.assert_array_equal(read(7, 20), vd.vis[7:27])


class TestCheckpointGuards:
    def test_rejections_warn(self, tmp_path, caplog):
        g = np.random.default_rng(1).standard_normal((8, 8))
        path = str(tmp_path / "ck.h5")
        fpr = ckpt.fingerprint(0.05, 1600, (4, 2, 2, 15, 15), "float64",
                               "wproj")
        ckpt.save(path, g, g, 100, 200, fpr=fpr)
        assert ckpt.load(path, 8, 200, fpr=fpr)[2] == 100
        bad = str(tmp_path / "bad.h5")
        with open(bad, "wb") as f:
            f.write(b"not an hdf5 file")
        for args, word in (((path, 8, 200, fpr + 1), "fingerprint"),
                           ((path, 8, 300, fpr), "total"),
                           ((path, 16, 200, fpr), "grid shape"),
                           ((bad, 8, 200, fpr), "unreadable")):
            caplog.clear()
            with caplog.at_level(logging.WARNING, LOG):
                assert ckpt.load(*args[:3], fpr=args[3]) is None
            assert any(word in r.message and r.name == LOG
                       for r in caplog.records), word

    def test_single_run_writes_float32(self, files, tmp_path):
        ck = str(tmp_path / "s.h5")
        runs.w_gridding_checkpointed(files.wk, files.vis, ck, slab=SLAB,
                                     config=_config("single"), _max_slabs=1,
                                     device="cpu")
        for name in (ckpt.GRID_RE, ckpt.GRID_IM):
            assert h5.read_dataset(ck, name).dtype == np.float32

    def test_mismatched_run_restarts(self, files, one_shot, tmp_path,
                                     caplog):
        ck = str(tmp_path / "m.h5")
        runs.w_gridding_checkpointed(files.wk, files.vis, ck, slab=SLAB,
                                     config=_config("single"), _max_slabs=1,
                                     device="cpu")
        with caplog.at_level(logging.WARNING, LOG):
            mx, img = runs.w_gridding_checkpointed(
                files.wk, files.vis, ck, slab=SLAB, config=_config(),
                device="cpu")
        assert any("fingerprint" in r.message for r in caplog.records)
        np.testing.assert_allclose(img, one_shot[1], rtol=1e-10, atol=1e-12)


class TestSlabPrefetcher:
    def test_slabs_in_order(self):
        data = np.arange(23)
        pf = SlabPrefetcher({"x": lambda s, c: data[s:s + c]}, 23, 5,
                            start=3)
        got = list(pf)
        assert [s for s, _ in got] == [3, 8, 13, 18]
        np.testing.assert_array_equal(
            np.concatenate([sl["x"] for _, sl in got]), data[3:])

    def test_reader_error_raised_on_consumer(self):
        def read(s, c):
            if s >= 10:
                raise OSError("disk gone")
            return np.zeros(c)

        pf = SlabPrefetcher({"x": read}, 30, 5)
        with pytest.raises(OSError, match="disk gone"):
            for _ in pf:
                pass
        pf._thread.join(5)
        assert not pf._thread.is_alive()

    def test_early_exit_releases_thread(self):
        started = threading.Event()

        def read(s, c):
            started.set()
            return np.zeros(c)

        pf = SlabPrefetcher({"x": read}, 10_000, 1, depth=1)
        for s0, _ in pf:
            if s0 >= 2:
                break
        assert started.is_set()
        pf._thread.join(5)
        assert not pf._thread.is_alive()
        assert pf.wait_s >= 0.0


class TestMetricsSink:
    def test_lines(self, tmp_path, monkeypatch):
        path = str(tmp_path / "m.jsonl")
        sink = MetricsSink(path)
        sink.emit("a", x=1)
        sink.emit("b", y=2.5, phases={"p": 0.1})
        recs = [json.loads(ln) for ln in open(path).read().splitlines()]
        assert [r["event"] for r in recs] == ["a", "b"]
        assert all(r["proc"] == 0 and isinstance(r["ts"], float)
                   for r in recs)
        assert recs[1]["y"] == 2.5 and recs[1]["phases"] == {"p": 0.1}
        env = str(tmp_path / "env.jsonl")
        monkeypatch.setenv("SKA_SDP_TPU_METRICS", env)
        MetricsSink().emit("c")
        assert json.loads(open(env).read())["event"] == "c"
        monkeypatch.delenv("SKA_SDP_TPU_METRICS")
        MetricsSink().emit("d")         # disabled: writes nothing


def _last(text, prefix):
    line = [ln for ln in text.splitlines() if ln.startswith(prefix)][-1]
    return float(re.findall(r"[-+0-9.e]+$", line)[0])


class TestCLI:
    @pytest.mark.parametrize("flags", [
        ["--checkpoint", "{d}/run.ckpt", "--slab", "50"],
        ["--checkpoint", "{d}/run.ckpt", "--slab", "50", "--out-of-core"],
        ["--device-phases"],
    ])
    def test_mode_w_prints_what_jax_prints(self, obs_dir, j, tmp_path,
                                           capsys, flags):
        flags = [f.format(d=tmp_path) for f in flags]
        base = ["--mode", "w", "-i", obs_dir, "--all", "--precision",
                "double", *GEO, *flags]
        assert j.cli.main(base + ["--backend", "cpu"]) == 0
        want = capsys.readouterr().out
        assert cli.main(base + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out
        want_mx = _last(want, "image max: ")
        assert abs(_last(got, "image max: ") - want_mx) < 1e-8 * want_mx
        stages = re.findall(r"\[device-phase\] (\S+)", want)
        assert re.findall(r"\[device-phase\] (\S+)", got) == stages
        assert not os.path.exists(tmp_path / "run.ckpt.h5")

    def test_checkpoint_ignores_staged_flags(self, obs_dir, tmp_path,
                                             capsys):
        assert cli.main(["--mode", "w", "-i", obs_dir, "--all", "--device",
                         "cpu", "--checkpoint", str(tmp_path / "c"),
                         "--device-phases", *GEO]) == 0
        err = capsys.readouterr().err
        assert "not supported on the checkpointed/out-of-core paths" in err

    def test_out_of_core_needs_checkpoint(self, obs_dir, j, capsys):
        args = ["--mode", "w", "-i", obs_dir, "--all", "--out-of-core", *GEO]
        assert j.cli.main(args + ["--backend", "cpu"]) == 1
        want = capsys.readouterr().err
        assert cli.main(args + ["--device", "cpu"]) == 1
        assert capsys.readouterr().err == want

    @pytest.mark.parametrize("mode", [["--mode", "w"],
                                      ["--mode", "aw", "--idg"],
                                      ["--mode", "predict", "--idg"]])
    def test_metrics_run_events(self, obs_dir, tmp_path, mode):
        m = str(tmp_path / "m.jsonl")
        extra = []
        if "predict" in mode:
            img = str(tmp_path / "model.h5")
            assert cli.main(["--mode", "w", "-i", obs_dir, "--all",
                             "--device", "cpu", "-o", img, *GEO]) == 0
            extra = ["--model", img]
        assert cli.main([*mode, "-i", obs_dir, "--all", "--device", "cpu",
                         "--metrics", m, *GEO, *extra]) == 0
        start, done = [json.loads(ln) for ln in open(m)]
        assert start["event"] == "run/start" and start["mode"] == mode[1]
        assert start["all"] is True and start["n"] is None
        assert done["event"] == "run/done"
        assert ("peak_vis" if "predict" in mode else "image_max") in done
        assert "ingest/vis" in done["phases"]
        assert isinstance(done["counters"], dict)
        if "--idg" in mode and "aw" in mode:
            assert done["counters"]["idg_aw/dropped"] == 0.0

    @pytest.mark.parametrize("flag", [["--gridder", "pallas"],
                                      ["--gridder", "xla"],
                                      ["--xla-dump", "x"],
                                      ["--backend", "tpu"]])
    def test_still_not_ported(self, obs_dir, capsys, flag):
        assert cli.main(["--mode", "w", "-i", obs_dir, "--all", *flag,
                         *GEO]) == 2
        assert "not yet ported" in capsys.readouterr().err


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def memory_obs():
    """The CLI observation in memory (the card's machine has no h5py)."""
    from ska_sdp_tpu_torch.io import synthetic

    cfg = synthetic.SyntheticConfig(theta=THETA, lam=LAM, nant=8, ntime=6,
                                    nw_planes=4, qpx=2)
    obs = synthetic.simulate_observation(cfg)
    centers = synthetic.w_plane_centers(obs, cfg)
    bank = np.stack([synthetic.w_kernel_host(THETA, float(w), 2, 128, 15)
                     for w in centers])
    return inputs.vis_data_from_observation(obs), bank, centers


class TestCuda:
    @pytest.mark.cuda
    def test_slabs_on_the_card(self, memory_obs, cuda_device):
        from ska_sdp_tpu_torch.kernels import wproj

        vd, bank, centers = memory_obs
        kw = dict(theta=THETA, lam=LAM, device=cuda_device)
        want = ds.w_image(vd, bank, centers, **kw).image.cpu().numpy()
        host = []
        wproj.reset_launch_count()
        assert ds.w_image_slabs(
            vd, bank, centers, slab=42, max_slabs=2, **kw,
            on_slab=lambda g, nxt: host.append((g.cpu().numpy(), nxt))
        ) is None
        res = ds.w_image_slabs(vd, bank, centers, slab=42,
                               start=host[-1][1], grid=host[-1][0], **kw)
        assert wproj.launch_count(wproj.GRID_KERNEL) == 4
        got = res.image.cpu().numpy()
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)

    @pytest.mark.cuda
    def test_streamed_on_the_card(self, memory_obs, cuda_device):
        vd, bank, centers = memory_obs
        readers = {"uvw": lambda s, c: vd.uvw[s:s + c],
                   "vis": lambda s, c: vd.vis[s:s + c]}
        n = vd.vis.shape[0]
        kw = dict(theta=THETA, lam=LAM, slab=50)
        got = ds.w_image_streamed(readers, n, vd.frequency, bank, centers,
                                  device=cuda_device, **kw)
        want = ds.w_image_streamed(readers, n, vd.frequency, bank, centers,
                                   device="cpu", **kw)
        g, w = got.image.cpu().numpy(), want.image.numpy()
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w)
        counts = ds.stream_weight_counts(readers["uvw"], n, vd.frequency,
                                         theta=THETA, lam=LAM, slab=50,
                                         device=cuda_device)
        np.testing.assert_array_equal(
            counts.cpu().numpy(),
            ds.stream_weight_counts(readers["uvw"], n, vd.frequency,
                                    theta=THETA, lam=LAM, slab=50,
                                    device="cpu").numpy())
