"""The program's spans and counters (``utils/timing.py``).

* each of the eight benchmarked in-memory entries logs nothing with no
  profiler recording, and under ``torch.profiler`` one root ``sdp.<entry>``
  a call whose children run in the layer order (host prep, device prep,
  kernel, finish, readback), nested inside it;
* the root's ``records`` are the call's, ``h2d_bytes`` and
  ``h2d_registered_bytes`` 0 on the CPU (on the card, the bytes of the
  host arrays handed over, once registered all but the frequency's), one
  ``sdp.readback`` a read the entry makes of its results; ``aw_image``'s
  root also counts the pair table the card's route builds (``aw_pairs``,
  ``aw_table_bytes``), whose distinct-pair count the host reads once
  between two device preps; ``psf_image``'s root (mode ``wcache`` with a
  fixed w range) counts the w-kernel planes synthesised, a bank for the
  image and another for the PSF, and the bytes of the screens they were
  transformed from (``wkernel_planes``, ``wkernel_bytes``), and reads
  nothing back;
  ``w_cache_bins`` reads the data's extent in one readback, and only
  without a range;
* only ``host_only`` spans enter the profiler's timeline;
* the span facility: counts summed up to the root, a span's own counts
  kept to itself, the log read without clearing, the clock shared with the
  profiler's events, the cost of a span with no profiler (reported);
* the counter registry behind the kernel modules' public readers;
* ``PhaseTimer.phase`` logs a span of its name, and with a trace
  directory writes the phase's spans beside its trace;
  ``kernels._build.load`` logs ``sdp.build.<name>``.
"""

import ctypes.util
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch import kernels
from ska_sdp_tpu_torch.config import KernelOptions
from ska_sdp_tpu_torch.io.inputs import vis_data_from_observation
from ska_sdp_tpu_torch.io.synthetic import (SyntheticConfig, akern_stamps,
                                            simulate_observation,
                                            w_plane_centers)
from ska_sdp_tpu_torch.kernels import _build
from ska_sdp_tpu_torch.models import dataset as ds
from ska_sdp_tpu_torch.models import imaging
from ska_sdp_tpu_torch.ops.wkernel import w_kernel
from ska_sdp_tpu_torch.utils import hostmem, timing

torch.set_num_threads(2)

THETA, LAM, N = 0.05, 5120, 256
CFG = SyntheticConfig(theta=THETA, lam=LAM, nant=6, ntime=4, nw_planes=4,
                      qpx=2, npix_ff=32, npix_kern=7)
# psf_image: w-cache bins of 2000 wavelengths over [0, 2000], 2 planes of
# the default kernel shape (a 256² far field padded to 2048²)
PSF_KW = dict(wstep=2000.0, w_range=(0.0, 2000.0))
PSF_PLANES = 2
HOST_ONLY = {"sdp.host_prep.cast", "sdp.host_prep.layout",
             "sdp.host_prep.register"}
# the direct children of each entry's root, in the order they start
CHILDREN = {
    "idg_image": ["sdp.host_prep", "sdp.device_prep", "sdp.device_prep",
                  "sdp.kernel.idg_grid", "sdp.finish", "sdp.readback",
                  "sdp.readback"],
    "idg_predict_vis": ["sdp.host_prep", "sdp.device_prep",
                        "sdp.device_prep", "sdp.kernel.idg_degrid",
                        "sdp.readback", "sdp.readback"],
    "aw_idg_image": ["sdp.host_prep", "sdp.device_prep", "sdp.readback",
                     "sdp.device_prep", "sdp.device_prep", "sdp.device_prep",
                     "sdp.kernel.idg_grid", "sdp.finish", "sdp.readback",
                     "sdp.readback"],
    "aw_predict_vis": ["sdp.host_prep", "sdp.device_prep", "sdp.readback",
                       "sdp.device_prep", "sdp.device_prep",
                       "sdp.device_prep", "sdp.kernel.idg_degrid",
                       "sdp.readback", "sdp.readback"],
    "w_image": ["sdp.host_prep", "sdp.device_prep", "sdp.kernel.wproj_grid",
                "sdp.finish", "sdp.readback"],
    "w_predict_vis": ["sdp.host_prep", "sdp.device_prep",
                      "sdp.kernel.wproj_gather", "sdp.readback"],
    # weights and mirroring, then the w-planes; the CPU's plain scatter
    "aw_image": ["sdp.host_prep", "sdp.device_prep", "sdp.device_prep",
                 "sdp.kernel.aw_grid", "sdp.finish", "sdp.readback"],
    # uvw to wavelengths; mirroring and weights; then for the image and
    # again for the PSF: the bins (rounded, then clipped to the range and
    # counted), the plane centres, the bank's synthesis, the scatter and
    # the finish (the PSF's divides both by its peak)
    "psf_image": ["sdp.host_prep", "sdp.device_prep", "sdp.device_prep"]
    + 2 * ["sdp.device_prep", "sdp.device_prep", "sdp.device_prep",
           "sdp.wkernel", "sdp.kernel.wproj_grid", "sdp.finish"],
}
# reads from the device: IDG-AW's distinct-pair count, then the dropped
# count, then the image maximum or the prediction's peak (w-projection
# predicts drop nothing); fused AW reads the image maximum, and on the
# card first its distinct-pair count
READS = {"idg_image": 2, "idg_predict_vis": 2, "aw_idg_image": 3,
         "aw_predict_vis": 3, "w_image": 1, "w_predict_vis": 1,
         "aw_image": 1, "psf_image": 0}
READS_ON_CARD = dict(READS, aw_image=2)
# counts of a root beside records and h2d_bytes: the pair table of fused
# AW (none on the CPU, whose plain scatter builds no table); the w-kernel
# planes of psf_image's two banks and the bytes of the 256² screens they
# were transformed from
OWN_COUNTS = {"aw_image": {"aw_pairs": 0, "aw_table_bytes": 0},
              "psf_image": {"wkernel_planes": 2 * PSF_PLANES,
                            "wkernel_bytes": 2 * PSF_PLANES * 256 ** 2 * 8}}
# hand-kernel launches a call: psf_image synthesises and scatters the image
# and the PSF
LAUNCHES = {"psf_image": 4}
ENTRIES = sorted(CHILDREN)


def _inputs():
    obs = simulate_observation(CFG)
    vd = vis_data_from_observation(obs)
    model = np.zeros((N, N), np.float32)
    model[N // 2, N // 2 + 3] = 1.0
    centers = w_plane_centers(obs, CFG)
    bank = w_kernel(THETA, torch.as_tensor(centers),
                    KernelOptions(qpx=2, npix_ff=32,
                                  npix_kern=7)).numpy()
    akerns = akern_stamps(CFG)[:, 0, 0]
    # fused AW takes A-kernels of the bank's 7² support: the stamps' middle
    return dict(vd=vd, model=model, akerns=akerns,
                akerns7=np.ascontiguousarray(akerns[:, 4:11, 4:11]),
                bank=bank, centers=centers)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _call(name, inp, device="cpu"):
    vd, kw = inp["vd"], dict(theta=THETA, lam=LAM, device=device)
    return {
        "idg_image": lambda: ds.idg_image(vd, **kw),
        "idg_predict_vis": lambda: ds.idg_predict_vis(vd, inp["model"], **kw),
        "aw_idg_image": lambda: ds.aw_idg_image(vd, inp["akerns"], **kw),
        "aw_predict_vis": lambda: ds.aw_predict_vis(vd, inp["akerns"],
                                                    inp["model"], **kw),
        "w_image": lambda: ds.w_image(vd, inp["bank"], inp["centers"], **kw),
        "w_predict_vis": lambda: ds.w_predict_vis(
            vd, inp["bank"], inp["centers"], inp["model"], **kw),
        "aw_image": lambda: ds.aw_image(vd, inp["bank"], inp["centers"],
                                        inp["akerns7"], **kw),
        "psf_image": lambda: ds.psf_image(vd, "wcache", **PSF_KW, **kw),
    }[name]()


def _h2d_bytes(name, inp):
    """``(h2d_bytes, h2d_registered_bytes)`` of an entry's call once the
    host arrays it is handed are registered: each copied in its own dtype
    (the IDG-AW entries' stamps, a strided view, through their span of the
    stamps), uvw, the visibilities (images) or the model (predicts), the
    A-kernel stamps and the antenna ids (A-terms), the bank and its
    centres (w-projection, fused AW), the antenna ids and times
    (``psf_image``, which hands them to its imaging function); the
    frequency's 4 bytes the pageable way."""
    vd = inp["vd"]
    arrays = [vd.uvw, vd.vis if name.endswith("image") else inp["model"]]
    if name == "psf_image":
        arrays += [vd.antenna1, vd.antenna2, vd.time]
    if name.startswith("aw_"):
        arrays += [inp["akerns7" if name == "aw_image" else "akerns"],
                   vd.antenna1, vd.antenna2]
    if name.startswith("w_") or name == "aw_image":
        arrays += [inp["bank"], inp["centers"]]
    registered = 0
    for a in arrays:
        lo, hi = hostmem._bounds(a)
        registered += hi - lo
    return registered + 4, registered


def _profiled(fn):
    """``(result, spans, profiler)`` of ``fn()`` under a CPU profiler."""
    timing.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = fn()
    return res, timing.spans(), prof


@pytest.mark.parametrize("name", ENTRIES)
def test_no_profiler_logs_nothing(inputs, name):
    timing.clear_spans()
    _call(name, inputs)
    assert timing.spans() == []


@pytest.mark.parametrize("name", ENTRIES)
def test_one_root_with_the_layers_in_order(inputs, name):
    _, log, _ = _profiled(lambda: _call(name, inputs))
    roots = [s for s in log if s.parent is None]
    assert [r.name for r in roots] == [f"sdp.{name}"]
    root = roots[0]
    assert all(s.root == root.id for s in log)
    kids = sorted((s for s in log if s.parent == root.id),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == CHILDREN[name]
    byid = {s.id: s for s in log}
    for s in log:
        if s.parent is not None:
            p = byid[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    prep = kids[0]
    under = {s.name for s in log if s.parent == prep.id}
    assert "sdp.host_prep.cast" in under
    assert under <= HOST_ONLY
    if name == "aw_idg_image":
        assert "sdp.host_prep.layout" in under


@pytest.mark.parametrize("name", ENTRIES)
def test_root_counts(inputs, name):
    _, log, _ = _profiled(lambda: _call(name, inputs))
    root = next(s for s in log if s.parent is None)
    # the CPU's tensors share the host arrays' memory: nothing is copied
    assert root.counts == {"records": inputs["vd"].uvw.shape[0],
                           "h2d_bytes": 0, "h2d_registered_bytes": 0,
                           **OWN_COUNTS.get(name, {})}
    assert sum(1 for s in log if s.name == "sdp.readback") == READS[name]
    assert all(s.counts == {} for s in log if s is not root)


@pytest.mark.parametrize("name", ENTRIES)
def test_only_host_only_spans_enter_the_profiler(inputs, name):
    _, log, prof = _profiled(lambda: _call(name, inputs))
    seen = {e.name for e in prof.events() if e.name.startswith("sdp.")}
    assert seen and seen <= HOST_ONLY
    assert seen <= {s.name for s in log}


@pytest.mark.parametrize("w_range, reads", [(None, 1), ((-2000.0, 0.0), 0)])
def test_w_cache_bins_reads_the_extent_only_without_a_range(inputs, w_range,
                                                             reads):
    """The extent's read, where there is one, sits between the two device
    preps of the arithmetic, not inside either."""
    uvw = torch.as_tensor(inputs["vd"].uvw) * 0.5
    (centers, _), log, _ = _profiled(
        lambda: imaging.w_cache_bins(uvw, 2000.0, w_range))
    assert [s.name for s in log] == (["sdp.device_prep"]
                                     + ["sdp.readback"] * reads
                                     + ["sdp.device_prep"])
    assert all(s.parent is None for s in log)
    if w_range is not None:
        assert list(centers) == [-2000.0, 0.0]


def test_aw_records_tables_reads_its_pair_count_once():
    """The card's route of fused AW's records and tables, run here on CPU
    tensors inside a root: a device prep, one read of the distinct-pair
    count, a device prep; the rows built and their bytes added to the
    root alone; the remap and the table those of ``torch.unique``'s."""
    rng = np.random.default_rng(11)
    nant, s, n = 6, 7, 400
    wk = torch.as_tensor((rng.standard_normal((2, 2, 2, s, s)) + 1j
                          * rng.standard_normal((2, 2, 2, s, s)))
                         .astype(np.complex64))
    ak = torch.as_tensor((rng.standard_normal((nant, s, s)) + 1j
                          * rng.standard_normal((nant, s, s)))
                         .astype(np.complex64))
    p = torch.as_tensor(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32))
    wbin = torch.as_tensor(rng.integers(0, 2, n).astype(np.int32))
    a1, a2 = (torch.as_tensor(rng.integers(0, nant, n).astype(np.int32))
              for _ in range(2))

    def body():
        with timing.span("sdp.aw_image", records=n, h2d_bytes=0,
                         aw_pairs=0, aw_table_bytes=0):
            return kernels.aw_fused.aw_records_tables(
                wk, ak, (64, 64), p, wbin, a1, a2)
    (rec, pt, ws), log, _ = _profiled(body)
    root = log[-1]
    kids = sorted((x for x in log if x.parent == root.id),
                  key=lambda x: x.start_ns)
    assert [x.name for x in kids] == ["sdp.device_prep", "sdp.readback",
                                      "sdp.device_prep"]
    pairs, inv = torch.unique(
        kernels.aw_fused.aw_records((64, 64), 2, s, nant, 8, p, wbin, a1,
                                    a2).pid, return_inverse=True)
    assert root.counts == {"records": n, "h2d_bytes": 0,
                           "aw_pairs": len(pairs),
                           "aw_table_bytes": len(pairs) * 16 * 16 * 8}
    assert all(x.counts == {} for x in kids)
    assert torch.equal(rec.pid, inv.to(torch.int32))
    want, _ = kernels.aw_fused.aw_tables(wk, ak, pairs)
    assert torch.equal(pt, want)


def test_counts_sum_up_to_the_root_and_own_counts_stay():
    def body():
        with timing.span("r", records=5):
            with timing.span("a", records=2):
                timing.add("x", 3)
                with timing.span("b", host_only=True):
                    timing.add("x")
            timing.add("y", 2)
    _, log, prof = _profiled(body)
    by = {s.name: s for s in log}
    assert [s.name for s in log] == ["b", "a", "r"]
    assert by["r"].counts == {"records": 5, "x": 4, "y": 2}
    assert by["a"].counts == {"records": 2, "x": 4}
    assert by["b"].counts == {"x": 1}
    assert by["b"].parent == by["a"].id and by["a"].parent == by["r"].id
    assert {s.root for s in log} == {by["r"].id}
    names = {e.name for e in prof.events()}
    assert "b" in names and "a" not in names and "r" not in names
    assert timing.spans() == log            # reading does not clear
    timing.clear_spans()
    assert timing.spans() == []


def test_counters_registry_keeps_the_public_readers():
    kernels.reset_drop_counters()
    timing.COUNTERS.reset("launches/wproj_grid")
    timing.launched("wproj_grid")
    kernels.note_drops("test_gridder", 3, "a test")
    assert timing.COUNTERS["dropped/test_gridder"] == 3
    assert kernels.drop_counters() == {"test_gridder": 3}
    assert kernels.wproj.launch_count(kernels.wproj.GRID_KERNEL) == 1
    kernels.reset_drop_counters()
    kernels.wproj.reset_launch_count()
    assert kernels.drop_counters() == {}
    assert kernels.wproj.launch_count(kernels.wproj.GRID_KERNEL) == 0
    with pytest.raises(KeyError):
        kernels.wproj.launch_count("aw_grid")


def test_readback_counts_tensor_reads_only():
    def body():
        with timing.span("sdp.root"):
            assert timing.readback(torch.tensor(2.5), float) == 2.5
            assert timing.readback(0, int) == 0
    _, log, _ = _profiled(body)
    assert [s.name for s in log] == ["sdp.readback", "sdp.root"]
    assert log[0].parent == log[1].id


def test_span_clock_is_the_profilers():
    timing.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timing.span("outer"):
            with torch.profiler.record_function("probe"):
                torch.ones(4).sum()
    base = prof.profiler.kineto_results.trace_start_ns()
    ev = next(e for e in prof.events() if e.name == "probe")
    start_ns = base + ev.time_range.start * 1000
    outer = timing.spans()[-1]
    assert abs(start_ns - outer.start_ns) < 2e6


def test_off_path_cost_is_reported():
    n = 100_000
    assert not torch.autograd._profiler_enabled()
    t0 = time.perf_counter()
    for _ in range(n):
        with timing.span("sdp.x"):
            pass
    us = (time.perf_counter() - t0) / n * 1e6
    print(f"off-path span: {us:.3f} us a span (with statement included)",
          file=sys.stderr)
    assert us < 50.0
    assert all(s.name != "sdp.x" for s in timing.spans())


def test_phase_logs_a_span_of_its_name():
    timer = timing.PhaseTimer(enabled=False)

    def body():
        with timer.phase("ingest/vis"):
            torch.ones(3).sum()
    _, log, _ = _profiled(body)
    assert [s.name for s in log] == ["ingest/vis"]
    assert timer.times["ingest/vis"] > 0
    timer.counters["idg_aw/dropped"] = 2.0
    assert timing.PhaseTimer().counters == {}


@pytest.mark.parametrize("how, waits", [
    ("quiet", False), ("printed", True), ("asked", True),
    ("profiled", True)])
def test_phase_waits_for_the_card_only_where_read(monkeypatch, how, waits):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a))
    timer = timing.PhaseTimer(enabled=how == "printed", trace_dir="",
                              wait=True if how == "asked" else None)

    def body():
        with timer.phase("grid/slab"):
            pass
    if how == "profiled":
        _profiled(body)
    else:
        body()
    assert len(calls) == int(waits)
    assert timer.times["grid/slab"] >= 0


def test_trace_dir_writes_the_phase_spans(tmp_path):
    timing.clear_spans()
    timer = timing.PhaseTimer(enabled=False, trace_dir=str(tmp_path))
    with timer.phase("grid/one"):
        with timing.span("sdp.inner", records=4):
            torch.ones(3).sum()
    assert not torch.autograd._profiler_enabled()
    written = sorted(p.name for p in tmp_path.iterdir())
    assert len(written) == 2 and written[1].endswith(".spans.json")
    assert written[0] == written[1].replace(".spans.json", ".json")
    assert written[0].startswith("grid_one-")
    got = json.loads((tmp_path / written[1]).read_text())
    assert [(s["name"], s["counts"]) for s in got] == [
        ("sdp.inner", {"records": 4}), ("grid/one", {})]
    assert got[0]["parent"] == got[1]["id"] and got[1]["parent"] is None
    with timer.phase("grid/two"):
        pass
    got = [json.loads(p.read_text()) for p in tmp_path.iterdir()
           if p.name.startswith("grid_two-")
           and p.name.endswith(".spans.json")]
    assert [[s["name"] for s in g] for g in got] == [["grid/two"]]


def test_build_logs_its_span_and_counts_compiles(tmp_path, monkeypatch):
    libm = ctypes.util.find_library("m")
    if libm is None:
        pytest.skip("no shared library to stand in for a build")
    lib = next((os.path.join(d, libm) for d in
                ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu",
                 "/lib64", "/usr/lib64", "/lib", "/usr/lib")
                if os.path.exists(os.path.join(d, libm))), None)
    if lib is None:
        pytest.skip("no shared library to stand in for a build")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a stand-in source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then shift; cp "' + lib
                    + '" "$1"; fi\n  shift\ndone\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build_log", {})
    _, log, prof = _profiled(lambda: _build.load("fake"))
    assert [s.name for s in log] == ["sdp.build.fake"]
    assert list(_build.build_log) == ["fake"]           # compiled
    assert "sdp.build.fake" in {e.name for e in prof.events()}
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build_log", {})
    _, log, _ = _profiled(lambda: _build.load("fake"))  # built: no compile
    assert [s.name for s in log] == ["sdp.build.fake"]
    assert _build.build_log == {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ENTRIES)
def test_on_the_card_counts_launches_and_bytes(name, cuda):
    inputs = _inputs()                   # buffers no earlier test registered
    for _ in range(2):                   # builds the kernels; registers
        _call(name, inputs, cuda)
    before = sum(timing.COUNTERS.group("launches/").values())
    _, log, prof = _profiled(lambda: _call(name, inputs, cuda))
    root = next(s for s in log if s.parent is None)
    assert sum(timing.COUNTERS.group("launches/").values()) - before \
        == LAUNCHES.get(name, 1)
    assert (root.counts["h2d_bytes"], root.counts["h2d_registered_bytes"]) \
        == _h2d_bytes(name, inputs)
    assert sum(1 for s in log if s.name == "sdp.readback") \
        == READS_ON_CARD[name]
    if name == "aw_image":
        vd = inputs["vd"]
        pairs = len(set(zip(vd.antenna1.tolist(), vd.antenna2.tolist())))
        assert root.counts["aw_pairs"] == pairs
        assert root.counts["aw_table_bytes"] == pairs * 16 * 16 * 8
    if name == "psf_image":
        for k, v in OWN_COUNTS[name].items():
            assert root.counts[k] == v
    seen = {e.name for e in prof.events() if e.name.startswith("sdp.")}
    assert seen <= HOST_ONLY
