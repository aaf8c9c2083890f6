"""The port's records from the reference preps' numpy outputs, for the
parity tests that feed one prep's records to the other's kernels.

The reference keeps its records in ``[8, n_pad]`` rows or ``[nblk, 8, C]``
blocks (three zero rows pad its sublanes); the port keeps the live rows
as tensors.  A helper module: pytest collects no test from it.
"""

import numpy as np
import torch


def from_jax_tile_records(recs, starts, order=None, valid=None,
                          device=None):
    """The port's records from the reference prep's numpy outputs.

    ``recs`` is the reference's ``[nblk, 8, 256]`` blocks layout (or ``[8,
    n_pad]`` rows).  Without ``order``: the gridder's ``(recs [5, n_pad],
    starts)`` of ``idg_bin_records``; the padding records lie past
    ``starts[-1]``, in no subgrid.  With ``order`` and ``valid`` (from
    ``_prep_with_order``): the degridder's ``(recs [3, n], starts, order,
    valid)``, cut to the ``n`` records."""
    r = np.asarray(recs, np.float32)
    if r.ndim == 3:
        r = r.transpose(1, 0, 2).reshape(8, -1)
    st = torch.as_tensor(np.array(starts, np.int32), device=device)
    if order is None:
        return torch.as_tensor(np.array(r[:5]), device=device), st
    od = np.array(order, np.int32)
    return (torch.as_tensor(np.array(r[:3, :od.shape[0]]), device=device),
            st, torch.as_tensor(od, device=device),
            torch.as_tensor(np.array(valid, bool), device=device))


def from_jax_run_records(recs, starts, ends, y0, x0, ia1, ia2, n_dropped,
                         device=None):
    """The port's run records from the reference prep's numpy outputs.

    ``recs`` is the reference's ``[8, n_pad]`` rows layout or its
    ``[nblk, 8, C]`` blocks layout; the three zero rows are dropped and the
    padding records (zero visibilities, outside every run) are kept.
    Returns the first eight entries of :func:`idg_aw_run_records`.
    """
    r = np.asarray(recs, np.float32)
    if r.ndim == 3:
        r = r.transpose(1, 0, 2).reshape(8, -1)
    rows = torch.as_tensor(np.array(r[:5]), device=device)

    def i32(a):
        return torch.as_tensor(np.array(a, np.int32), device=device)

    return (rows, i32(starts), i32(ends), i32(y0), i32(x0), i32(ia1),
            i32(ia2), torch.as_tensor(int(np.asarray(n_dropped)),
                                      device=device))


def from_jax_degrid_records(recs, starts_ext, y0, x0, ia1, ia2, order_s,
                            use, n_dropped, device=None):
    """The port's degrid records from the reference prep's numpy outputs
    (``idg_aw_degrid_records``): the ``[nblk, 8, C]`` blocks become
    ``[3, n]`` rows (the padding records, outside every run, are cut).
    Returns the tuple of :func:`idg_aw_degrid_records`."""
    order = np.asarray(order_s, np.int32)
    n = order.shape[0]
    r = np.asarray(recs, np.float32).transpose(1, 0, 2).reshape(8, -1)

    def i32(a):
        return torch.as_tensor(np.array(a, np.int32), device=device)

    return (torch.as_tensor(np.array(r[:3, :n]), device=device),
            i32(starts_ext), i32(y0), i32(x0), i32(ia1), i32(ia2), i32(order),
            torch.as_tensor(np.array(use, bool), device=device),
            torch.as_tensor(int(np.asarray(n_dropped)), device=device))
