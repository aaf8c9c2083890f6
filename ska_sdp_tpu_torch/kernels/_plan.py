"""The work plan of the binned CUDA scatters (``csrc/aw_grid.cu`` by pair
row, ``csrc/wproj_grid.cu`` by output tile), in plain PyTorch.

Both kernels key their entries (a bin, or ``nbins`` for none), sort the
keys stably on the card, and give each warp a window of ``window``
consecutive sorted entries, which it walks run by run: a run of one bin is
one work item.  This module computes the same items, so that the CPU can
check them; the card builds them itself, inside the kernel's call.
"""

from __future__ import annotations

import torch


def binned_items(key: torch.Tensor, nbins: int, window: int):
    """``(order, items)`` for the int32 bins ``key`` ``[e]`` (a bin in
    ``[0, nbins)``, or ``nbins`` for an entry in none).

    ``order`` ``[e]`` (int64) lists the entries by bin, in input order
    within a bin, the unbinned last.  ``items`` ``[3, k]`` (int32) holds
    the bin and the first and end positions in ``order`` of each maximal
    run of one bin inside an aligned window of ``window`` positions, in
    order: every binned entry lies in exactly one item, and no item is
    longer than ``window``."""
    skey, order = torch.sort(key, stable=True)
    pos = torch.arange(key.shape[0], device=key.device)
    cut = pos % window == 0
    cut[1:] |= skey[1:] != skey[:-1]
    first = torch.nonzero(cut).flatten()
    end = torch.cat([first[1:], pos[-1:] + 1])
    live = skey[first] < nbins
    return order, torch.stack([skey[first], first, end])[:, live].to(
        torch.int32)
