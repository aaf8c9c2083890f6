"""Multi-device scale-out on ``torch.distributed`` (port of
``ska_sdp_tpu/parallel/``): one process a device, NCCL on the card and
gloo on the CPU.

The reference's ``vis_sharding`` / ``replicated`` shardings have no tensor
counterpart: a rank holds its own block of records
(:func:`shard_range`) and every replicated input whole.
"""

from .distributed import initialize, make_host_vis_mesh
from .fft import fft2_centered_sharded, make_sharded_ifft2
from .ingest import load_vis_sharded
from .mesh import VIS_AXIS, Mesh, make_mesh, pad_to_multiple, shard_range
from .sharded import (
    make_sharded_idg_aw_step,
    make_sharded_idg_step,
    make_sharded_predict_step,
    make_sharded_spectral_idg_step,
    make_sharded_wproj_step,
    make_sharded_wproj_step_gridfft,
    make_sharded_wproj_step_gridscatter,
    sharded_wproj_grid,
    sharded_wproj_image,
)

__all__ = [
    "Mesh",
    "VIS_AXIS",
    "fft2_centered_sharded",
    "initialize",
    "load_vis_sharded",
    "make_host_vis_mesh",
    "make_mesh",
    "make_sharded_idg_aw_step",
    "make_sharded_idg_step",
    "make_sharded_predict_step",
    "make_sharded_spectral_idg_step",
    "make_sharded_ifft2",
    "make_sharded_wproj_step",
    "make_sharded_wproj_step_gridfft",
    "make_sharded_wproj_step_gridscatter",
    "pad_to_multiple",
    "shard_range",
    "sharded_wproj_grid",
    "sharded_wproj_image",
]
