"""Sharded imaging: visibility-parallel gridding with partial grids merged
by one all-reduce (port of ``ska_sdp_tpu/parallel/sharded.py``).

* visibilities (uvw, vis, antenna ids) shard over the ranks in contiguous
  blocks (``mesh.shard_range``); each rank grids its block into a private
  partial uv-grid through the port's hand-written kernels;
* ``dist.all_reduce`` merges the partial grids (the reference's ``psum``);
* Hermitian completion, the inverse FFT and the taper run on the merged
  grid on every rank, or, for the large-grid steps, on each rank's row
  block after a row reduce-scatter (``psum_scatter``), with the distributed
  Hermitian (``ppermute``: point-to-point exchanges) and the pencil FFT.

Uniform weighting is global: each rank counts its records' cells
(``ops.weighting.cell_counts``), one all-reduce sums the histograms and
each rank looks its records up in the sum, so the weights equal the
single-device ones.  (``sharded_wproj_image`` keeps the reference's
per-shard weights.)

Each ``make_*`` returns a plain callable.  Every rank calls it together
with its own shard and replicated inputs; it returns the image on every
rank, or the rank's row block where the reference's output is row-sharded
(``_gridfft``, ``_gridscatter``), or the rank's predicted visibilities.
"""

from __future__ import annotations

import torch

from ..kernels import idg_aw_gridder, idg_gridder, wproj_gridder
from ..models.dataset import idg_finish, predict_pipeline
from ..ops import (doweight, ifft_centered, make_grid_hermitian, mirror_uvw,
                   uvw_lambda)
from ..ops.search import find_closest
from ..ops.weighting import cell_counts, counts_at, weight_cells
from .fft import check_pencil, fft2_centered_sharded
from .mesh import Mesh, all_reduce_, reduce_scatter_rows, swap


def _grid_size(theta: float, lam: int) -> int:
    return int(round(theta * lam))


def _global_counts(theta: float, lam: int, uvw_l, weights, mesh: Mesh):
    """``(cell ids, summed histogram)`` of this shard's records at qpx=1."""
    n = _grid_size(theta, lam)
    flat = weight_cells(theta, lam, uvw_l)
    return flat, all_reduce_(cell_counts(flat, n * n, weights), mesh)


def _global_weights(theta: float, lam: int, uvw_l, mesh: Mesh):
    """Uniform weights ``1/count`` of this shard's records (``uvw_l`` in
    wavelengths) from the histogram of every shard."""
    ones = torch.ones(uvw_l.shape[:1], dtype=uvw_l.dtype,
                      device=uvw_l.device)
    flat, counts = _global_counts(theta, lam, uvw_l, ones, mesh)
    return 1.0 / counts_at(counts, flat)


def _image(grid):
    return ifft_centered(make_grid_hermitian(grid)).real


def _weighted_mirrored(theta, lam, uvw, freq, vis, mesh):
    """Wavelengths, global uniform weights and v ≥ 0 mirroring of this
    shard: ``(uvw1, wt·vis1)``."""
    uvw_l = uvw_lambda(freq, uvw)
    wt = _global_weights(theta, lam, uvw_l, mesh)
    uvw1, vis1 = mirror_uvw(uvw_l, vis)
    return uvw1, wt.to(vis.dtype) * vis1


def _wproj_partial(bank_conj, centers, uvw, freq, vis, *, theta, lam, chunk,
                   mesh):
    """This shard's partial uv-grid of the bank w-projection step."""
    n = _grid_size(theta, lam)
    uvw1, vis1 = _weighted_mirrored(theta, lam, uvw, freq, vis, mesh)
    wbin = find_closest(centers, uvw1[:, 2])
    return wproj_gridder(bank_conj, (n, n), uvw1 / lam, wbin, vis1,
                         chunk=chunk)


def sharded_wproj_grid(mesh: Mesh, bank_conj, p, wbin, vis, n_grid: int,
                       chunk: int = 8192):
    """The merged ``[n, n]`` uv-grid of every shard's ``p``/``wbin``/``vis``
    scattered through the conjugated bank."""
    part = wproj_gridder(bank_conj, (n_grid, n_grid), p, wbin, vis,
                         chunk=chunk)
    return all_reduce_(part, mesh)


def sharded_wproj_image(mesh: Mesh, bank_conj, wbin_centers, uvw_l, vis,
                        theta: float, lam: int, chunk: int = 8192):
    """w-projection dirty image from λ-scaled uvw.  The weighting is the
    shard's own (``ops.doweight`` on the shard), as in the reference."""
    n = _grid_size(theta, lam)
    wt = doweight(theta, lam, uvw_l, torch.ones_like(vis))
    uvw1, vis1 = mirror_uvw(uvw_l, vis)
    wbin = find_closest(wbin_centers, uvw1[:, 2])
    part = wproj_gridder(bank_conj, (n, n), uvw1 / lam, wbin, wt * vis1,
                         chunk=chunk)
    return _image(all_reduce_(part, mesh))


def make_sharded_wproj_step(mesh: Mesh, theta: float, lam: int,
                            chunk: int = 1024):
    """``(bank_conj, centers, uvw_m, freq, vis) → image`` on every rank:
    global uniform weights, the shard's bank scatter, one all-reduce,
    Hermitian completion and the centred inverse FFT."""

    def step(bank_conj, centers, uvw, freq, vis):
        part = _wproj_partial(bank_conj, centers, uvw, freq, vis,
                              theta=theta, lam=lam, chunk=chunk, mesh=mesh)
        return _image(all_reduce_(part, mesh))

    return step


def make_sharded_wproj_step_gridfft(mesh: Mesh, theta: float, lam: int,
                                    chunk: int = 1024):
    """:func:`make_sharded_wproj_step` whose FFT is distributed: after the
    all-reduce and the Hermitian completion each rank keeps its row block
    and runs the pencil inverse FFT; returns the rank's row block
    ``[n/P, n]`` of the image.  Needs n divisible by P²."""
    n = _grid_size(theta, lam)
    check_pencil(n, n, mesh)
    hl = n // mesh.size

    def step(bank_conj, centers, uvw, freq, vis):
        part = _wproj_partial(bank_conj, centers, uvw, freq, vis,
                              theta=theta, lam=lam, chunk=chunk, mesh=mesh)
        herm = make_grid_hermitian(all_reduce_(part, mesh))
        block = herm[mesh.rank * hl:(mesh.rank + 1) * hl]
        return fft2_centered_sharded(block, mesh, inverse=True).real

    return step


def make_sharded_idg_step(mesh: Mesh, theta: float, lam: int,
                          subgrid: int = 32, taper_beta: float = 12.0):
    """``(uvw_m, freq, vis) → taper-corrected image`` on every rank: global
    uniform weights, the shard's IDG gridder (``kernels.idg_gridder``), one
    all-reduce, Hermitian completion, the inverse FFT and the division by
    the fine taper."""
    n = _grid_size(theta, lam)

    def step(uvw, freq, vis):
        uvw1, vis1 = _weighted_mirrored(theta, lam, uvw, freq, vis, mesh)
        part, _ = idg_gridder((n, n), uvw1 / lam, uvw1[:, 2], vis1,
                              theta=theta, subgrid=subgrid,
                              taper_beta=taper_beta)
        return idg_finish(all_reduce_(part, mesh), n, n, 0, subgrid,
                          taper_beta, uvw.dtype)

    return step


def make_sharded_predict_step(mesh: Mesh, theta: float, lam: int,
                              chunk: int = 1024):
    """``(bank, centers, image, uvw_m, freq) → vis`` of this shard: the
    model image is replicated and each rank degrids its own records
    (``kernels.wproj_degridder``); no collective."""

    def step(bank, centers, img, uvw, freq):
        return predict_pipeline(bank, centers, img, uvw, freq, theta=theta,
                                lam=lam, chunk=chunk)

    return step


def _hermitian_rows_sharded(block, n_grid: int, mesh: Mesh):
    """Hermitian completion of a row-sharded even-size grid, equal to
    ``ops.make_grid_hermitian`` of the whole grid, without ever holding
    the whole grid: the mirror's rows come from the opposite rank (its
    row-reversed block, and the first row of rank ``(P−d) mod P``); the
    column mirror is local.  Both pairings are their own inverse; a rank
    paired with itself copies."""
    P, d = mesh.size, mesh.rank
    h = block.shape[0]
    # rows n−y for y in my range live (reversed) on rank P−1−d …
    recv = swap(torch.flip(block, dims=(0,)), P - 1 - d, mesh)
    # … except row n−d·h, the first row of rank (P−d) mod P
    extra = swap(block[:1], (P - d) % P, mesh)
    mrows = torch.cat([extra, recv[:h - 1]], dim=0)
    if d == 0:
        mrows[0] = 0          # global row 0 of the mirror is zeroed
    # column mirror x ← (n−x) mod n, column 0 zeroed
    mirr = torch.roll(torch.flip(mrows, dims=(1,)), 1, dims=1)
    mirr[:, 0] = 0
    return block + torch.conj(mirr)


def make_sharded_wproj_step_gridscatter(mesh: Mesh, theta: float, lam: int,
                                        chunk: int = 1024):
    """The grid-distributed step: the partial grids merge by a row
    reduce-scatter, so no rank holds the whole merged grid; the Hermitian
    completion is :func:`_hermitian_rows_sharded` and the inverse FFT the
    pencil transform.  Returns the rank's row block ``[n/P, n]``.  Needs n
    divisible by P²."""
    n = _grid_size(theta, lam)
    check_pencil(n, n, mesh)

    def step(bank_conj, centers, uvw, freq, vis):
        part = _wproj_partial(bank_conj, centers, uvw, freq, vis,
                              theta=theta, lam=lam, chunk=chunk, mesh=mesh)
        block = reduce_scatter_rows(part, mesh)
        herm = _hermitian_rows_sharded(block, n, mesh)
        return fft2_centered_sharded(herm, mesh, inverse=True).real

    return step


def make_sharded_spectral_idg_step(mesh: Mesh, theta: float, lam: int,
                                   g: int, subgrid: int = 64,
                                   taper_beta: float = 12.0):
    """``(uvw_m, mask, f_ref, ratios [g], vis_mc [g, n]) → cube [g, n, n]``
    on every rank: one channel group, each channel gridded at its own
    coordinates (the reference channel's dilated by ``ratios[c]``) and
    merged by one all-reduce a channel.

    The uniform weights are the group's: one histogram of ``mask`` (1.0 a
    real record, 0.0 padding) at the reference channel, summed over the
    ranks; a record's weight is ``mask / max(count, 1)``, so padding to a
    multiple of the mesh size changes nothing."""
    n = _grid_size(theta, lam)

    def step(uvw, mask, f_ref, ratios, vis_mc):
        if vis_mc.shape[0] != g:
            raise ValueError(f"{vis_mc.shape[0]} channels for a group of "
                             f"{g}")
        uvw0 = uvw_lambda(f_ref, uvw)
        flat, counts = _global_counts(theta, lam, uvw0, mask.to(uvw.dtype),
                                      mesh)
        wt = mask / torch.clamp(counts_at(counts, flat), min=1.0)
        neg = uvw0[:, 1] < 0
        uvw1 = torch.where(neg[:, None], -uvw0, uvw0)
        vis1 = torch.where(neg[None, :], torch.conj(vis_mc), vis_mc) \
            * wt.to(vis_mc.dtype)[None, :]
        grids = []
        for r, vc in zip(ratios.to(uvw.dtype), vis1):
            part, _ = idg_gridder((n, n), uvw1 * r / lam, uvw1[:, 2] * r, vc,
                                  theta=theta, subgrid=subgrid,
                                  taper_beta=taper_beta)
            grids.append(all_reduce_(part, mesh))
        return idg_finish(torch.stack(grids), n, n, 0, subgrid, taper_beta,
                          uvw.dtype)

    return step


def make_sharded_idg_aw_step(mesh: Mesh, theta: float, lam: int,
                             subgrid: int = 64, taper_beta: float = 12.0,
                             max_runs: int = 4096):
    """``(uvw_m, freq, vis, a1, a2, screens) → (image, dropped)`` on every
    rank: global uniform weights, the shard's IDG-AW gridder
    (``kernels.idg_aw_gridder``, its run prep on the shard's records
    bounded by ``max_runs``), one all-reduce of the partial grids and one
    of the drop counts.  Screens ``[nant, S, S]`` are replicated."""
    n = _grid_size(theta, lam)

    def step(uvw, freq, vis, a1, a2, screens):
        uvw1, vis1 = _weighted_mirrored(theta, lam, uvw, freq, vis, mesh)
        part, nd = idg_aw_gridder((n, n), uvw1 / lam, a1, a2, uvw1[:, 2],
                                  vis1, screens, theta=theta,
                                  subgrid=subgrid, taper_beta=taper_beta,
                                  max_runs=max_runs)
        nd = all_reduce_(nd.to(torch.int64).reshape(1).clone(), mesh)[0]
        return idg_finish(all_reduce_(part, mesh), n, n, 0, subgrid,
                          taper_beta, uvw.dtype), nd

    return step
