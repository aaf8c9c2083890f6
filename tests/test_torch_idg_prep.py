"""Port parity: IDG run prep (record keys, fused sort, run CSR) against the
JAX reference's ``_record_keys`` and ``idg_aw_run_records``.

The integer outputs (keys, ``starts``, ``ends``, ``y0``, ``x0``, ``ia1``,
``ia2``, ``n_dropped``) must match exactly, and so must the sorted record
rows: both sides compute the record offsets with the same float32
operations in the same order, so even a record that sits exactly on a
tile boundary falls into the same tile on both sides (checked below with
records placed on boundaries).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ska_sdp_tpu.kernels.idg_aw_pallas import (  # noqa: E402
    idg_aw_run_records as j_run_records)
from ska_sdp_tpu.ops.idg_aw import _record_keys as j_record_keys  # noqa: E402
from ska_sdp_tpu_torch.kernels.idg_aw_records import (  # noqa: E402
    from_jax_run_records, idg_aw_run_records)
from ska_sdp_tpu_torch.ops.idg_aw import _record_keys  # noqa: E402

from test_torch_idg_grid import random_problem, track_problem  # noqa: E402

torch.set_num_threads(2)

N = 256


def _both(p, w, a1, a2, vis, **kw):
    j = j_run_records((N, N), jnp.asarray(p), jnp.asarray(a1),
                      jnp.asarray(a2), jnp.asarray(w),
                      jnp.asarray(vis.real), jnp.asarray(vis.imag),
                      layout="rows", **kw)
    t = idg_aw_run_records((N, N), torch.as_tensor(p), torch.as_tensor(a1),
                           torch.as_tensor(a2), torch.as_tensor(w),
                           torch.as_tensor(vis.real),
                           torch.as_tensor(vis.imag), **kw)
    return j, t


def _assert_same_records(j, t, n):
    names = ("starts", "ends", "y0", "x0", "ia1", "ia2", "n_dropped")
    for name, a, b in zip(names, j[1:8], t[1:8]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    assert tuple(j[8]) == tuple(t[8])
    np.testing.assert_array_equal(np.asarray(j[0])[:5, :n], t[0].numpy())


class TestRecordKeys:
    @pytest.mark.parametrize("S", [32, 64, 128])
    def test_keys_offsets_masks_exact(self, S):
        rng = np.random.default_rng(S)
        p, w, a1, a2, _ = random_problem(rng, 4000, extent=0.6)
        a1 = rng.integers(0, 40, 4000).astype(np.int32)
        a2 = rng.integers(0, 40, 4000).astype(np.int32)
        a1[:8] = 2**15            # past the pair-key envelope: unfit
        a2[8:16] = -1
        support = 15 if S > 32 else 7
        j = j_record_keys((N, N), jnp.asarray(p), jnp.asarray(a1),
                          jnp.asarray(a2), S, support, 0)
        t = _record_keys((N, N), torch.as_tensor(p), torch.as_tensor(a1),
                         torch.as_tensor(a2), S, support, 0)
        for a, b in zip(j[:6], t[:6]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert tuple(j[6:]) == tuple(t[6:])
        assert not t[5][:16].any()

    def test_records_on_tile_boundaries(self):
        # place records exactly on tile edges of the padded grid
        S, s = 64, 15
        tc = 24
        cells = np.arange(S, S + N, tc, dtype=np.float64)
        yy, xx = np.meshgrid(cells, cells, indexing="ij")
        p = np.zeros((yy.size, 3), np.float32)
        p[:, 1] = ((yy.ravel() - S - N // 2) / N).astype(np.float32)
        p[:, 0] = ((xx.ravel() - S - N // 2) / N).astype(np.float32)
        zer = np.zeros(yy.size, np.int32)
        j = j_record_keys((N, N), jnp.asarray(p), jnp.asarray(zer),
                          jnp.asarray(zer), S, s, 0)
        t = _record_keys((N, N), torch.as_tensor(p), torch.as_tensor(zer),
                         torch.as_tensor(zer), S, s, 0)
        for a, b in zip(j[:6], t[:6]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


class TestRunRecords:
    @pytest.mark.parametrize("nant", [0, 1])
    def test_unit_screen_random_uv(self, nant):
        rng = np.random.default_rng(11)
        p, w, a1, a2, vis = random_problem(rng)
        p[:30, 0] = 0.7                       # out of bounds: not counted
        j, t = _both(p, w, a1, a2, vis, max_runs=((N + 128) // 24 + 2) ** 2
                     + 64, nant=nant)
        _assert_same_records(j, t, p.shape[0])
        assert int(t[7]) == 0

    @pytest.mark.parametrize("nant,ordered", [(6, False), (0, False),
                                              (6, True)])
    def test_track_data(self, nant, ordered):
        rng = np.random.default_rng(12)
        p, w, a1, a2, vis = track_problem(rng)
        j, t = _both(p, w, a1, a2, vis, max_runs=4096, nant=nant,
                     ordered=ordered)
        _assert_same_records(j, t, p.shape[0])

    @pytest.mark.parametrize("nant", [0, 6])
    def test_overflow_and_unfit_are_counted(self, nant):
        rng = np.random.default_rng(13)
        p, w, a1, a2, vis = track_problem(rng)
        a1 = a1.copy()
        a1[:5] = 2**15 + 1                    # unfit: dropped and counted
        j, t = _both(p, w, a1, a2, vis, max_runs=10, nant=nant)
        _assert_same_records(j, t, p.shape[0])
        assert int(t[7]) > 5                  # run-table overflow drops

    def test_from_jax_run_records_both_layouts(self):
        rng = np.random.default_rng(14)
        p, w, a1, a2, vis = track_problem(rng, nant=4, ntime=40)
        args = ((N, N), jnp.asarray(p), jnp.asarray(a1), jnp.asarray(a2),
                jnp.asarray(w), jnp.asarray(vis.real), jnp.asarray(vis.imag))
        rows = j_run_records(*args, max_runs=512, layout="rows")
        blocks = j_run_records(*args, max_runs=512, layout="blocks")
        a = from_jax_run_records(*[np.asarray(x) for x in rows[:8]])
        b = from_jax_run_records(*[np.asarray(x) for x in blocks[:8]])
        assert a[0].shape == (5, np.asarray(rows[0]).shape[1])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
        np.testing.assert_array_equal(a[0][:, p.shape[0]:].numpy(), 0.0)

    def test_rejects_empty_input(self):
        e = torch.zeros((0, 3))
        z = torch.zeros((0,), dtype=torch.int32)
        with pytest.raises(ValueError):
            idg_aw_run_records((N, N), e, z, z, z.float(), z.float(),
                               z.float())
