"""Rank layout and the collectives of the sharded steps (port of
``ska_sdp_tpu/parallel/mesh.py``).

One process drives one device.  The reference's 1-D ``("vis",)`` mesh is
the process group's ranks in rank order: visibilities shard over them in
contiguous blocks (:func:`shard_range`, the layout ``P("vis")`` gives),
each rank grids its block into a private partial grid, and one
``all_reduce`` merges the partial grids.  Kernel banks and screens are
replicated: every rank holds the whole tensor.

Collectives run on NCCL on the card and on gloo on the CPU.  Complex
tensors travel as their ``torch.view_as_real`` views, so both backends see
real tensors.  A point-to-point exchange whose peer is the rank itself is
a local copy: gloo cannot send to its own rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

VIS_AXIS = "vis"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of ``group`` laid out over ``axis_names`` (``shape`` ranks
    along each), with this process's ``rank`` and its ``device``."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis_names: tuple = (VIS_AXIS,)
    shape: tuple = ()


def resolve_device(device, rank: int) -> torch.device:
    """``cuda:{rank % device_count}`` unless ``device`` asks for the CPU;
    raises when no CUDA device is visible and the CPU was not asked for."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: pass device='cpu' to run "
                           "the sharded steps on gloo with the plain kernels")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D mesh over the visibility axis: every rank of the default process
    group, each on :func:`resolve_device`'s device.  Without a process
    group it first makes one (``parallel.initialize``: a world of one
    unless ``SKA_SDP_TPU_COORDINATOR`` is set).  ``n_devices`` must be the
    world size: one process drives one device."""
    if not dist.is_initialized():
        from .distributed import initialize

        initialize(device=device)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices needs "
                         f"{n_devices} processes; the world has {size}")
    rank = dist.get_rank()
    return Mesh(dist.group.WORLD, rank, size, resolve_device(device, rank),
                (VIS_AXIS,), (size,))


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def shard_range(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous block of ``n`` records (``n`` a multiple of
    the mesh size)."""
    if n % mesh.size:
        raise ValueError(f"{n} records do not split evenly over "
                         f"{mesh.size} devices (pad_to_multiple)")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its conjugation resolved (a copy if needed)."""
    return t.resolve_conj().contiguous()


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def all_reduce_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the mesh, in place where ``t`` is dense."""
    t = _dense(t)
    dist.all_reduce(_real(t), group=mesh.group)
    return t


_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def reduce_scatter_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` ``[H, …]`` over the mesh, of which this rank keeps
    its row block ``[H/P, …]``."""
    t = _dense(t)
    out = t.new_empty((t.shape[0] // mesh.size,) + tuple(t.shape[1:]))
    _reduce_scatter(_real(out), _real(t), group=mesh.group)
    return out


def all_to_all_blocks(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` ``[P, …]``: block ``j`` goes to rank ``j``; returns ``[P, …]``
    whose block ``i`` came from rank ``i``."""
    t = _dense(t)
    out = torch.empty_like(t)
    dist.all_to_all_single(_real(out), _real(t), group=mesh.group)
    return out


def swap(t: torch.Tensor, peer: int, mesh: Mesh) -> torch.Tensor:
    """Send ``t`` to rank ``peer`` and return the tensor of ``t``'s shape
    that ``peer`` sends back: one step of a pairing every rank takes part
    in.  With the rank itself as peer it is a local copy."""
    t = _dense(t)
    if peer == mesh.rank:
        return t.clone()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, _real(t), peer, mesh.group),
           dist.P2POp(dist.irecv, _real(out), peer, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out
