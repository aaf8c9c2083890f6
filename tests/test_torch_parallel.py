"""Port parity for the multi-device scale-out (``ska_sdp_tpu_torch.parallel``
and ``models.spectral.idg_cube_sharded``).

For each P in {1, 2, 4} one module-scoped spawn starts P gloo ranks on the
CPU (``SKA_SDP_TPU_COORDINATOR`` for P > 1, a world of one on a
``HashStore`` for P = 1); each rank runs every sharded step on its block
of the same numpy inputs (seed 7) and saves what it holds.  The JAX
package's own sharded steps run here on ``make_mesh(P)`` over conftest's
CPU devices.  Bounds (rel-L2):

* 1e-9 where both sides run in double: the bank w-projection steps (grid,
  image, the replicated, pencil-FFT and reduce-scatter finishes) and the
  predict step; the records include ones off the grid whose cell ids wrap,
  are dropped by the histogram and clamped by the lookup;
* 1e-4 over the central 75% (the image contract the port's other IDG
  tests hold to the JAX package) for the IDG and IDG-AW images and the
  sharded cube driver: the port's IDG kernels sum in single precision, the
  JAX side in double on its XLA route; at S=64 the two routes differ by
  ~4e-5 already at P = 1, S=32 and IDG-AW by ~1e-5 (the P-independence is
  the dry run's check); outside the central 75% the taper division
  amplifies the rounding;
* exact: the IDG-AW drop count (a run bound that drops records), the
  row-sharded Hermitian against ``make_grid_hermitian`` of the whole grid
  (P = 1 is all self-exchanges), and the sharded ingest against the
  whole-file reads; the pencil FFT within 1e-12 of ``ifft_centered``.

The ``cuda`` test runs two steps at world size 1 on NCCL against the same
steps on the plain kernels on the card, and skips without a card.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch.io.synthetic import SyntheticConfig, simulate_observation
from ska_sdp_tpu_torch.io.synthetic import write_vis_file

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THETA, LAM = 0.05, 2560          # a 128² grid
N = 128
B = 96                           # records of the step inputs (P divides it)
N_CUBE = 119                     # records of the cube: no P > 1 divides it
C = 299792458.0
DOUBLE_TOL = 1e-9
IDG_TOL = 1e-4
AW_MAX_RUNS = 12                 # small enough that the prep drops records


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _crop(a):
    c = a.shape[-1] // 8
    return a[..., c:-c, c:-c]


def _cplx(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _inputs():
    """The steps' inputs, float64 / complex128 from numpy seed 7."""
    rng = np.random.default_rng(7)
    uvw = rng.uniform(-0.3 * LAM, 0.3 * LAM, size=(B, 3))
    uvw[:, 2] = rng.uniform(-100, 100, size=B)
    # off the grid: u past the edge (its cell id spills into the next
    # row), v below it (a negative id, wrapped), v above it (an id past
    # the end: dropped by the histogram, clamped by the lookup onto the
    # last cell, which the next record occupies)
    edge = (N / 2 - 1) / N * LAM
    uvw[:4, :2] = [[0.52 * LAM, 0.1 * LAM], [0.1 * LAM, -0.52 * LAM],
                   [-0.2 * LAM, 0.52 * LAM], [edge, edge]]
    # cells shared across shards at every P > 1, so the weights need the
    # summed histogram
    uvw[60:76, :2] = uvw[4:20, :2] + 0.01
    nant = 5
    a1 = rng.integers(0, nant - 1, B)
    ak = np.zeros((nant, 9, 9), np.complex128)
    ak[:, 4, 4] = 1.0
    ak += 0.05 * _cplx(rng, ak.shape)
    return dict(
        uvw=uvw, vis=_cplx(rng, B),
        bank=_cplx(rng, (3, 2, 2, 7, 7)), centers=np.linspace(-100, 100, 3),
        p=rng.uniform(-0.35, 0.35, size=(B, 3)),
        wbin=rng.integers(0, 3, B).astype(np.int32),
        model=rng.standard_normal((N, N)),
        a1=a1.astype(np.int32), a2=(a1 + 1).astype(np.int32), ak=ak,
        grid=_cplx(rng, (N, N)))


_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist

from ska_sdp_tpu_torch.io.inputs import load_vis_data
from ska_sdp_tpu_torch.models.spectral import idg_cube_sharded
from ska_sdp_tpu_torch.ops.idg_aw import aw_screens_host
from ska_sdp_tpu_torch.parallel import (
    fft2_centered_sharded, initialize, load_vis_sharded, make_mesh,
    make_sharded_idg_aw_step, make_sharded_idg_step,
    make_sharded_predict_step, make_sharded_wproj_step,
    make_sharded_wproj_step_gridfft, make_sharded_wproj_step_gridscatter,
    shard_range, sharded_wproj_grid, sharded_wproj_image)
from ska_sdp_tpu_torch.parallel.sharded import _hermitian_rows_sharded

torch.set_num_threads(1)
theta, lam, N, C, max_runs = (float(sys.argv[3]), int(sys.argv[4]),
                              int(sys.argv[5]), float(sys.argv[6]),
                              int(sys.argv[7]))
initialize(device="cpu")
try:
    mesh = make_mesh(device="cpu")
    d = dict(np.load(sys.argv[1]))
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    sl = shard_range(t["uvw"].shape[0], mesh)
    rows = slice(mesh.rank * N // mesh.size, (mesh.rank + 1) * N // mesh.size)
    uvw, vis = t["uvw"][sl], t["vis"][sl]
    bank_c = torch.conj(t["bank"]).resolve_conj()
    out = {}
    out["grid"] = sharded_wproj_grid(mesh, bank_c, t["p"][sl],
                                     t["wbin"][sl], vis, N, chunk=8)
    out["image"] = sharded_wproj_image(mesh, bank_c, t["centers"], uvw, vis,
                                       theta, lam, chunk=8)
    out["w"] = make_sharded_wproj_step(mesh, theta, lam, chunk=8)(
        bank_c, t["centers"], uvw, C, vis)
    out["w_fft"] = make_sharded_wproj_step_gridfft(mesh, theta, lam, chunk=8)(
        bank_c, t["centers"], uvw, C, vis)
    out["w_scatter"] = make_sharded_wproj_step_gridscatter(
        mesh, theta, lam, chunk=8)(bank_c, t["centers"], uvw, C, vis)
    for S in (32, 64):
        out[f"idg{S}"] = make_sharded_idg_step(mesh, theta, lam, subgrid=S)(
            uvw, C, vis)
    out["predict"] = make_sharded_predict_step(mesh, theta, lam, chunk=8)(
        t["bank"], t["centers"], t["model"], uvw, C)
    scr = torch.as_tensor(aw_screens_host(d["ak"], 64).astype(np.complex64))
    out["aw"], out["aw_dropped"] = make_sharded_idg_aw_step(
        mesh, theta, lam, subgrid=64, max_runs=max_runs)(
        uvw, C, vis, t["a1"][sl], t["a2"][sl], scr)
    cube = idg_cube_sharded(load_vis_data(sys.argv[8]), mesh, channels=4,
                            theta=theta, lam=lam, n=int(sys.argv[9]))
    out["cube"] = cube.cube
    g = t["grid"]
    out["herm"] = _hermitian_rows_sharded(g[rows].clone(), N, mesh)
    out["ifft"] = fft2_centered_sharded(g[rows].clone(), mesh, inverse=True)
    out["fft"] = fft2_centered_sharded(g[rows].clone(), mesh)
    uvw_i, vis_i, f_i = load_vis_sharded(sys.argv[8], mesh, n=int(sys.argv[9]),
                                         precision="double")
    out["ingest_uvw"], out["ingest_vis"] = uvw_i, vis_i
    out["ingest_freq"] = torch.tensor(f_i)
    np.savez(os.path.join(sys.argv[2], f"rank{mesh.rank}.npz"),
             **{k: v.numpy() for k, v in out.items()})
finally:
    dist.destroy_process_group()
"""

# outputs that each rank holds a block of; the rest are whole on every rank
_ROW_BLOCKS = ("w_fft", "w_scatter", "herm", "ifft", "fft")
_RECORD_BLOCKS = ("predict", "ingest_uvw", "ingest_vis")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    obs = simulate_observation(SyntheticConfig(theta=THETA, lam=LAM, nant=6,
                                               ntime=21, nchan=4, seed=5))
    write_vis_file(str(d / "vis.h5"), obs)
    return dict(dir=d, inputs=inp, vis=str(d / "vis.h5"), obs=obs)


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda p: f"P{p}")
def port(request, data):
    """Every sharded step of the port on P gloo ranks: the outputs
    assembled over the ranks, and P."""
    P = request.param
    out_dir = data["dir"] / f"P{P}"
    out_dir.mkdir()
    script = data["dir"] / "worker.py"
    script.write_text(_WORKER)
    port_no = _free_port()
    procs = []
    for rank in range(P):
        env = dict(os.environ, PYTHONPATH=REPO)
        for k in ("SKA_SDP_TPU_COORDINATOR", "SKA_SDP_TPU_NPROCS",
                  "SKA_SDP_TPU_PROC_ID"):
            env.pop(k, None)
        if P > 1:
            env.update(SKA_SDP_TPU_COORDINATOR=f"127.0.0.1:{port_no}",
                       SKA_SDP_TPU_NPROCS=str(P),
                       SKA_SDP_TPU_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(data["dir"] / "inputs.npz"),
             str(out_dir), str(THETA), str(LAM), str(N), str(C),
             str(AW_MAX_RUNS), data["vis"], str(N_CUBE)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO))
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(P)]
    got = {k: (np.concatenate([r[k] for r in ranks])
               if k in _ROW_BLOCKS + _RECORD_BLOCKS else ranks[0][k])
           for k in ranks[0]}
    for k in ranks[0]:          # the replicated outputs agree on every rank
        if k not in _ROW_BLOCKS + _RECORD_BLOCKS:
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    return got, P


@pytest.fixture(scope="module")
def jax_steps(data):
    """The JAX package's sharded steps on a P-device mesh, per P (cached)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ska_sdp_tpu import parallel as jp
    from ska_sdp_tpu.config import GridParams, ImagingConfig
    from ska_sdp_tpu.models.spectral import idg_gridding_multi_sharded
    from ska_sdp_tpu.ops.idg_aw import aw_screens_host

    cache = {}
    d = data["inputs"]

    def run(P, key):
        if (P, key) in cache:
            return cache[P, key]
        mesh = jp.make_mesh(P)
        a = {k: jnp.asarray(v) for k, v in d.items()}
        bank_c = jnp.conj(a["bank"])
        freq = jnp.asarray(C)
        # the two unjitted reference functions, jitted here for speed
        if key == "grid":
            r = jax.jit(lambda *x: jp.sharded_wproj_grid(mesh, *x, N,
                                                         chunk=8))(
                bank_c, a["p"], a["wbin"], a["vis"])
        elif key == "image":
            r = jax.jit(lambda *x: jp.sharded_wproj_image(
                mesh, *x, THETA, LAM, chunk=8))(
                bank_c, a["centers"], a["uvw"], a["vis"])
        elif key in ("w", "w_fft", "w_scatter"):
            make = {"w": jp.make_sharded_wproj_step,
                    "w_fft": jp.make_sharded_wproj_step_gridfft,
                    "w_scatter": jp.make_sharded_wproj_step_gridscatter}[key]
            r = make(mesh, THETA, LAM, chunk=8)(bank_c, a["centers"],
                                                a["uvw"], freq, a["vis"])
        elif key.startswith("idg"):
            r = jp.make_sharded_idg_step(mesh, THETA, LAM,
                                         subgrid=int(key[3:]))(
                a["uvw"], freq, a["vis"])
        elif key == "predict":
            r = jp.make_sharded_predict_step(mesh, THETA, LAM, chunk=8)(
                a["bank"], a["centers"], a["model"], a["uvw"], freq)
        elif key == "aw":
            scr = jnp.asarray(aw_screens_host(d["ak"], 64).astype(
                np.complex64))
            img, nd = jp.make_sharded_idg_aw_step(
                mesh, THETA, LAM, subgrid=64, max_runs=AW_MAX_RUNS)(
                a["uvw"], freq, a["vis"], a["a1"], a["a2"], scr)
            r = (np.asarray(img), int(nd))
        elif key == "cube":
            cfg = ImagingConfig(grid=GridParams(theta=THETA, lam=LAM))
            r = idg_gridding_multi_sharded(data["vis"], 4, n=N_CUBE,
                                           config=cfg, mesh=mesh)[2]
        cache[P, key] = r if key == "aw" else np.asarray(r)
        return cache[P, key]

    return run


class TestShardedSteps:
    @pytest.mark.parametrize("key", ["grid", "image", "w", "w_fft",
                                     "w_scatter", "predict"])
    def test_wproj_steps_double(self, port, jax_steps, key):
        got, P = port
        want = jax_steps(P, key)
        assert got[key].shape == want.shape
        assert _rel(got[key], want) < DOUBLE_TOL

    @pytest.mark.parametrize("S", [32, 64])
    def test_idg_step(self, port, jax_steps, S):
        got, P = port
        want = jax_steps(P, f"idg{S}")
        assert got[f"idg{S}"].shape == want.shape == (N, N)
        assert _rel(_crop(got[f"idg{S}"]), _crop(want)) < IDG_TOL

    def test_idg_aw_step_and_drops(self, port, jax_steps):
        got, P = port
        img, nd = jax_steps(P, "aw")
        assert int(got["aw_dropped"]) == nd
        assert nd > 0                   # the run bound does drop records
        assert _rel(_crop(got["aw"]), _crop(img)) < IDG_TOL

    def test_cube_driver_pads_records(self, port, jax_steps):
        got, P = port
        want = jax_steps(P, "cube")
        assert got["cube"].shape == want.shape == (4, N, N)
        for c in range(4):
            assert _rel(_crop(got["cube"][c]), _crop(want[c])) < IDG_TOL


class TestCollectives:
    def test_hermitian_rows_exact(self, port, data):
        from ska_sdp_tpu_torch.ops import make_grid_hermitian

        got, _ = port
        want = make_grid_hermitian(torch.as_tensor(data["inputs"]["grid"]))
        np.testing.assert_array_equal(got["herm"], want.numpy())

    @pytest.mark.parametrize("direction", ["ifft", "fft"])
    def test_pencil_fft(self, port, data, direction):
        from ska_sdp_tpu_torch.ops import fft_centered, ifft_centered

        got, _ = port
        fn = ifft_centered if direction == "ifft" else fft_centered
        want = fn(torch.as_tensor(data["inputs"]["grid"])).numpy()
        assert _rel(got[direction], want) < 1e-12

    def test_ingest_reads_each_slice(self, port, data):
        got, P = port
        obs = data["obs"]
        n = N_CUBE - N_CUBE % P
        np.testing.assert_array_equal(got["ingest_uvw"], obs["uvw"][:n])
        vis0 = np.asarray(obs["vis"]).reshape(-1, 4)[:n, 0]
        np.testing.assert_array_equal(got["ingest_vis"], vis0)
        assert float(got["ingest_freq"]) == float(obs["frequency"][0])

    @pytest.mark.parametrize("n_grid", [72, 50])
    def test_pencil_shape_refused(self, n_grid):
        from ska_sdp_tpu_torch.parallel import (
            fft2_centered_sharded, make_sharded_wproj_step_gridscatter)
        from ska_sdp_tpu_torch.parallel.mesh import Mesh

        mesh = Mesh(None, 0, 4, torch.device("cpu"))     # no collective runs
        with pytest.raises(ValueError, match="mesh_size"):
            fft2_centered_sharded(torch.zeros((n_grid // 4, n_grid),
                                              dtype=torch.complex128), mesh)
        with pytest.raises(ValueError, match="mesh_size"):
            make_sharded_wproj_step_gridscatter(mesh, n_grid / 1000, 1000)


class TestDryrunAndGuards:
    def test_dryrun_multichip_two_ranks(self):
        from ska_sdp_tpu_torch.parallel.dryrun import dryrun_multichip

        dryrun_multichip(2)

    def test_import_loads_no_jax_and_mesh_needs_a_device(self):
        code = (
            "import sys, torch\n"
            "import ska_sdp_tpu_torch.parallel as par\n"
            "import ska_sdp_tpu_torch.parallel.dryrun\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'ska_sdp_tpu.'))]\n"
            "assert not bad, bad\n"
            "assert not torch.cuda.is_available()\n"
            "try:\n"
            "    par.make_mesh()\n"
            "except RuntimeError as e:\n"
            "    assert 'no CUDA device' in str(e), e\n"
            "else:\n"
            "    raise SystemExit('make_mesh ran without a GPU')\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n")
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop("SKA_SDP_TPU_COORDINATOR", None)
        subprocess.run([sys.executable, "-c", code], check=True, env=env,
                       cwd=REPO, timeout=120)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_steps_on_nccl_world_of_one(cuda_device, monkeypatch):
    """``make_sharded_wproj_step`` and ``make_sharded_idg_aw_step`` at world
    size 1 on NCCL through the CUDA kernels, against the same steps with
    the kernels swapped for their plain versions on the card: image rel-L2
    ≤ 5e-5 (w) and ≤ 1e-4 over the central 75% (IDG-AW), equal drops."""
    import torch.distributed as dist

    from ska_sdp_tpu_torch.kernels import idg_aw_stream as stream
    from ska_sdp_tpu_torch.ops.gridding import convgrid_wproj
    from ska_sdp_tpu_torch.ops.idg_aw import aw_screens_host
    from ska_sdp_tpu_torch.parallel import (initialize, make_mesh,
                                            make_sharded_idg_aw_step,
                                            make_sharded_wproj_step)
    from ska_sdp_tpu_torch.parallel import sharded

    d = _inputs()
    dev = cuda_device
    t = {k: torch.as_tensor(v, device=dev) for k, v in d.items()}
    uvw = t["uvw"].to(torch.float32)
    vis = t["vis"].to(torch.complex64)
    bank_c = torch.conj(t["bank"].to(torch.complex64)).resolve_conj()
    centers = t["centers"].to(torch.float32)
    scr = torch.as_tensor(aw_screens_host(d["ak"], 64).astype(np.complex64),
                          device=dev)

    def run(mesh):
        w = make_sharded_wproj_step(mesh, THETA, LAM)(bank_c, centers, uvw,
                                                      C, vis)
        aw, nd = make_sharded_idg_aw_step(mesh, THETA, LAM, subgrid=64,
                                          max_runs=AW_MAX_RUNS)(
            uvw, C, vis, t["a1"], t["a2"], scr)
        torch.cuda.synchronize()
        return w.cpu().numpy(), aw.cpu().numpy(), int(nd)

    initialize(device=dev)
    try:
        mesh = make_mesh(device=dev)
        got = run(mesh)

        def scatter(bank, shape, p, wbin, v, chunk):
            return convgrid_wproj(bank, torch.zeros(shape, dtype=v.dtype,
                                                    device=v.device),
                                  p, wbin, v, chunk=chunk)

        def streamed(recs, st, en, y0, x0, i1, i2, shape, s, *, theta,
                     subgrid, taper_beta):
            g = stream.grid_from_records_plain(
                recs, st, en, y0, x0, i1, i2, s, grid_shape=shape,
                theta=theta, subgrid=subgrid, taper_beta=taper_beta)
            return g[subgrid:subgrid + shape[0], subgrid:subgrid + shape[1]]

        monkeypatch.setattr(sharded, "wproj_gridder", scatter)
        monkeypatch.setattr(stream, "idg_aw_grid_from_records_stream",
                            streamed)
        want = run(mesh)
    finally:
        dist.destroy_process_group()
    assert _rel(got[0], want[0]) < 5e-5
    assert got[2] == want[2]
    assert _rel(_crop(got[1]), _crop(want[1])) < 1e-4
