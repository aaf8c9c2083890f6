"""Distributed centred 2-D FFT of a row-sharded grid (port of
``ska_sdp_tpu/parallel/fft.py``): the pencil decomposition.

* the grid ``[H, W]`` is row-sharded: rank ``d`` holds rows
  ``[d·H/P, (d+1)·H/P)``;
* the fftshift / ifftshift sandwich of the centred transform folds into
  local ``(−1)^index`` masks (shift theorem, even sizes): no communication;
* each axis runs as a full-length local FFT, with one all-to-all transpose
  between the two passes and one to restore the row sharding.

``all_to_all_single`` splits dimension 0 only, so the ``[H/P, W]`` block is
laid out as ``[P, H/P, W/P]`` (block ``j`` the columns rank ``j`` takes)
before the first exchange and the received blocks stack to ``[H, W/P]``.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, all_to_all_blocks


def _sign_mask(n_rows: int, n_cols: int, row_offset: int, dtype, device):
    """``(−1)^{global_row + col}`` for an ``[n_rows, n_cols]`` block."""
    gy = row_offset + torch.arange(n_rows, device=device)
    gx = torch.arange(n_cols, device=device)
    odd = (gy[:, None] + gx[None, :]) % 2 == 1
    return torch.where(odd, -1.0, 1.0).to(dtype)


def check_pencil(n_rows: int, n_cols: int, mesh: Mesh) -> None:
    """The pencil transform's shape condition: the rows divisible by the
    mesh size squared, the columns by the mesh size."""
    p2 = mesh.size * mesh.size
    if n_rows % p2 or n_cols % mesh.size:
        raise ValueError(f"grid {n_rows}x{n_cols} not divisible by "
                         f"mesh_size² = {p2}")


def fft2_centered_sharded(x: torch.Tensor, mesh: Mesh,
                          inverse: bool = False) -> torch.Tensor:
    """This rank's row block of ``shift∘(i)fft2∘ishift`` of the global grid
    whose row block ``[H/P, W]`` (complex, H and W even, H divisible by P²
    and W by P) is ``x``.  Every rank of the mesh calls it together."""
    P, d = mesh.size, mesh.rank
    hl, W = x.shape
    H = hl * P
    check_pencil(H, W, mesh)
    fft = torch.fft.ifft if inverse else torch.fft.fft
    mask = _sign_mask(hl, W, d * hl, x.dtype, x.device)

    # ishift on both axes → (−1)^j pre-mask; pass 1 along the whole row
    x = fft(x * mask, dim=1)
    # [H/P, W] → [P, H/P, W/P] → exchange → [H, W/P]
    x = all_to_all_blocks(x.reshape(hl, P, W // P).transpose(0, 1), mesh)
    # pass 2 along the whole column
    x = fft(x.reshape(H, W // P), dim=0)
    # [H, W/P] = [P, H/P, W/P] → exchange → [H/P, W]
    x = all_to_all_blocks(x.reshape(P, hl, W // P), mesh)
    x = x.transpose(0, 1).reshape(hl, W)
    # shift on both axes → (−1)^k post-mask and (−1)^{H/2 + W/2}
    sign = 1.0 if (H // 2 + W // 2) % 2 == 0 else -1.0
    return x * (mask * sign)


def make_sharded_ifft2(mesh: Mesh):
    """The centred inverse FFT of a row-sharded grid: a callable from this
    rank's row block ``[H/P, W]`` to its row block of the image."""

    def ifft2(block: torch.Tensor) -> torch.Tensor:
        return fft2_centered_sharded(block, mesh, inverse=True)

    return ifft2
