"""The multi-device dry run (the torch counterpart of the reference's
``__graft_entry__.dryrun_multichip``): every sharded step at tiny shapes on
``n`` gloo ranks on the CPU, each held to the unsharded chain.

    python -c "from ska_sdp_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(4)"

The ranks are ``n`` processes started here (``spawn``), meeting at a free
port of 127.0.0.1.  Each builds the whole problem from a seed, runs the
steps on its shard and checks its output; any failing rank fails the run.
"""

from __future__ import annotations

import multiprocessing
import socket
import time

import numpy as np
import torch

THETA, LAM = 0.05, 1280          # 64² grid
C = 299792458.0                  # a frequency whose λ-scale is 1


def example_problem(n_vis: int):
    """The reference dry run's problem: a 4-plane, qpx=2, 7² w-kernel bank
    over |w| ≤ 1000, uniform uvw (|u|, |v| ≤ 0.4·lam metres, |w| ≤ 900) at
    frequency c and Gaussian visibilities, from numpy seed 0: ``(conjugated
    bank [4, 2, 2, 7, 7] complex64, centres, uvw, vis)``."""
    from ..config import KernelOptions
    from ..ops.wkernel import w_kernel_bank

    rng = np.random.default_rng(0)
    centers = np.linspace(-1000.0, 1000.0, 4)
    bank = w_kernel_bank(THETA, torch.as_tensor(centers, dtype=torch.float32),
                         KernelOptions(qpx=2, npix_ff=128, npix_kern=7),
                         dtype=torch.float32)
    uvw = rng.uniform(-0.4 * LAM, 0.4 * LAM, size=(n_vis, 3))
    uvw[:, 2] = rng.uniform(-900, 900, size=n_vis)
    vis = rng.standard_normal(n_vis) + 1j * rng.standard_normal(n_vis)
    return (bank, torch.as_tensor(centers, dtype=torch.float32),
            torch.as_tensor(uvw, dtype=torch.float32),
            torch.as_tensor(vis, dtype=torch.complex64))


def _close(got, want, atol, rtol, what):
    if not np.allclose(np.asarray(got), np.asarray(want), atol=atol,
                       rtol=rtol):
        err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
        raise AssertionError(f"{what}: max |err| {err:.3e} (atol {atol}, "
                             f"rtol {rtol})")


def _crop(a):
    c = a.shape[-1] // 8
    return a[..., c:-c, c:-c]


def run_checks(mesh) -> None:
    """Every sharded step on ``mesh`` against the unsharded chain on the
    whole problem; raises on the first disagreement."""
    from ..models.dataset import (aw_idg_pipeline, idg_pipeline,
                                  wproj_pipeline)
    from ..models.spectral import group_inputs
    from ..ops.idg_aw import aw_screens_host
    from . import sharded
    from .mesh import shard_range

    P = mesh.size
    n = int(round(THETA * LAM))
    bank_c, centers, uvw, vis = example_problem(64 * P)
    f = torch.tensor(C, dtype=torch.float32)
    sl = shard_range(uvw.shape[0], mesh)
    rows = slice(mesh.rank * (n // P), (mesh.rank + 1) * (n // P))

    # w-projection, replicated finish: the reference dry run's tolerance
    ref, _ = wproj_pipeline(bank_c, centers, uvw, f, vis, theta=THETA,
                            lam=LAM, chunk=64)
    img = sharded.make_sharded_wproj_step(mesh, THETA, LAM, chunk=64)(
        bank_c, centers, uvw[sl], C, vis[sl])
    _close(img, ref, 1e-5, 1e-5, "sharded w step")

    # IDG at S=32 (the fixed-tile route), central 75%: outside it the
    # taper division amplifies summation-order rounding
    ref_idg, _, _ = idg_pipeline(uvw, f, vis, theta=THETA, lam=LAM,
                                 subgrid=32, taper_beta=12.0)
    img = sharded.make_sharded_idg_step(mesh, THETA, LAM, subgrid=32)(
        uvw[sl], C, vis[sl])
    _close(_crop(img), _crop(ref_idg), 1e-4, 1e-4, "sharded IDG step")

    # IDG-AW at S=64 with the reference's run bound, drops summed
    nant, s_aw = 4, 9
    ak = np.zeros((nant, s_aw, s_aw), np.complex64)
    ak[:, s_aw // 2, s_aw // 2] = 1.0
    ak += 0.05 * np.random.default_rng(3).standard_normal(ak.shape)
    scr = torch.as_tensor(aw_screens_host(ak, 64).astype(np.complex64))
    a1 = torch.as_tensor(np.random.default_rng(5).integers(
        0, nant - 1, uvw.shape[0]), dtype=torch.int32)
    a2 = a1 + 1
    ref_aw, _, nd_ref = aw_idg_pipeline(scr, uvw, a1, a2, f, vis,
                                        theta=THETA, lam=LAM, subgrid=64,
                                        max_runs=2048)
    img, nd = sharded.make_sharded_idg_aw_step(
        mesh, THETA, LAM, subgrid=64, max_runs=2048)(
        uvw[sl], C, vis[sl], a1[sl], a2[sl], scr)
    if int(nd) != int(nd_ref):
        raise AssertionError(f"sharded IDG-AW dropped {int(nd)}, the "
                             f"unsharded chain {int(nd_ref)}")
    _close(_crop(img), _crop(ref_aw), 1e-4, 1e-4, "sharded IDG-AW step")

    # a 2-channel group, each channel at its own coordinates
    freqs = np.array([C, 1.002 * C])
    f_ref = float(np.float32(freqs.mean()))
    ratios = torch.as_tensor((freqs / f_ref).astype(np.float32))
    vis_mc = torch.stack([vis, 0.5 * vis])
    mask = torch.ones(uvw.shape[0], dtype=torch.float32)
    cube = sharded.make_sharded_spectral_idg_step(
        mesh, THETA, LAM, g=2, subgrid=32)(uvw[sl], mask[sl], f_ref, ratios,
                                           vis_mc[:, sl])
    uvw1, vis1 = group_inputs(uvw, f_ref, ratios, vis_mc, theta=THETA,
                              lam=LAM, exact=False)
    for c in range(2):
        ref_c, _ = _idg_channel(uvw1, vis1[c], ratios[c], n)
        _close(_crop(cube[c]), _crop(ref_c), 1e-4, 1e-4,
               f"sharded spectral step, channel {c}")

    # the distributed finishes: pencil FFT, and reduce-scatter with the
    # distributed Hermitian (n divisible by P²)
    if n % (P * P) == 0:
        for make in (sharded.make_sharded_wproj_step_gridfft,
                     sharded.make_sharded_wproj_step_gridscatter):
            block = make(mesh, THETA, LAM, chunk=64)(
                bank_c, centers, uvw[sl], C, vis[sl])
            _close(block, ref[rows], 1e-5, 1e-5, make.__name__)


def _idg_channel(uvw1, vis1, r, n):
    """One channel of the unsharded chain: the IDG gridder at the
    channel's dilated coordinates, then the IDG finish."""
    from ..kernels import idg_gridder
    from ..models.dataset import idg_finish

    guv, nd = idg_gridder((n, n), uvw1 * r / LAM, uvw1[:, 2] * r, vis1,
                          theta=THETA, subgrid=32, taper_beta=12.0)
    return idg_finish(guv, n, n, 0, 32, 12.0), nd


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int) -> None:
    import torch.distributed as dist

    from .distributed import initialize
    from .mesh import make_mesh

    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", n, rank, device="cpu")
    try:
        run_checks(make_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """One run of every sharded step on ``n_devices`` gloo CPU ranks, each
    held to the unsharded chain (tiny shapes: a 64² grid, 64 records a
    rank).  Raises ``RuntimeError`` when a rank fails or is still running
    after ten minutes."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n_devices, port))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 600.0
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if bad:
        raise RuntimeError(f"dry run failed on {n_devices} ranks: exit codes "
                           f"{bad}")
