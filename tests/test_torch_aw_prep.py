"""IDG-AW's two derived inputs, built where the records are.

* ``ops.idg_aw.aw_screens`` against its numpy twin ``aw_screens_host`` and
  the JAX package's ``aw_screens``, in complex128 (rtol 1e-12); a delta
  stamp gives unit screens;
* ``models.dataset.antenna_screens`` returns ``prec.complex`` on the
  requested device, from numpy or tensor stamps;
* ``models.dataset.aw_run_bound`` counts exactly the distinct pairs
  ``np.unique`` counts: ids with gaps, autocorrelations, one pair, no
  record, int32 and int64, numpy and tensors; ``pair_count``, which the
  IDG-AW cube sizes its bound from, counts what its ``torch.unique``
  counted;
* ``aw_idg_image`` and ``aw_predict_vis`` on the CPU against the same
  pipelines fed with ``aw_screens_host`` screens and the ``np.unique``
  bound (rtol 1e-6; the same dropped count);
* on the card: the screens and the count built there against the host
  twin and ``np.unique``.
"""

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch.io import inputs
from ska_sdp_tpu_torch.io.synthetic import (SyntheticConfig,
                                            simulate_observation)
from ska_sdp_tpu_torch.models import dataset as ds
from ska_sdp_tpu_torch.ops.idg import fov_pad_geometry
from ska_sdp_tpu_torch.ops.idg_aw import aw_screens, aw_screens_host
from ska_sdp_tpu_torch.types import DOUBLE, SINGLE

torch.set_num_threads(2)

THETA, LAM, N = 0.05, 5120, 256
CFG = SyntheticConfig(theta=THETA, lam=LAM, nant=10, ntime=12)


def _stamps(nant=10, s=15, seed=9):
    rng = np.random.default_rng(seed)
    ak = np.zeros((nant, s, s), np.complex128)
    ak[:, s // 2, s // 2] = 1.0
    ak += 0.05 * (rng.standard_normal(ak.shape)
                  + 1j * rng.standard_normal(ak.shape))
    return ak


def _np_bound(a1, a2, n):
    """The IDG-AW ``max_runs`` counted on the host by ``np.unique``."""
    a1, a2 = np.asarray(a1, np.int64), np.asarray(a2, np.int64)
    nant_b = int(max(a1.max(initial=0), a2.max(initial=0))) + 2
    return 8 * len(np.unique(a1 * nant_b + a2)) + n // 128 + 64


@pytest.mark.parametrize("S", [32, 64])
@pytest.mark.parametrize("fov_scale", [1.0, 1.25])
def test_screens_match_the_host_twin(S, fov_scale):
    ak = _stamps()
    got = aw_screens(torch.as_tensor(ak), S, fov_scale,
                     dtype=torch.complex128)
    assert got.dtype == torch.complex128 and got.shape == (10, S, S)
    np.testing.assert_allclose(got.numpy(),
                               aw_screens_host(ak, S, fov_scale),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("fov_scale", [1.0, 1.25])
def test_screens_match_the_reference(fov_scale):
    pytest.importorskip("jax")
    from ska_sdp_tpu.ops import idg_aw as j_idg_aw
    import jax.numpy as jnp

    ak = _stamps()
    want = np.asarray(j_idg_aw.aw_screens(jnp.asarray(ak), 64,
                                          dtype=jnp.complex128,
                                          fov_scale=fov_scale))
    assert want.dtype == np.complex128
    got = aw_screens(torch.as_tensor(ak), 64, fov_scale,
                     dtype=torch.complex128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def test_delta_stamp_gives_unit_screens():
    ak = np.zeros((3, 15, 15), np.complex64)
    ak[:, 7, 7] = 1.0
    got = aw_screens(torch.as_tensor(ak), 32)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), np.ones((3, 32, 32)))


@pytest.mark.parametrize("prec", [SINGLE, DOUBLE], ids=["single", "double"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_aw_screens_dtype_device_and_values(prec, as_tensor):
    ak = _stamps()
    fov_pad = 0.75
    n_t, n_g, _, _ = fov_pad_geometry(THETA, LAM, fov_pad)
    stamps = torch.as_tensor(ak) if as_tensor else ak
    got = ds.antenna_screens(stamps, 64, THETA, LAM, fov_pad, prec, "cpu")
    assert got.dtype == prec.complex and got.device.type == "cpu"
    # the parent's arithmetic: stamps in prec, screens in complex128, cast
    want = aw_screens_host(ak.astype(prec.np_complex), 64,
                           fov_scale=n_g / n_t).astype(prec.np_complex)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6
                               if prec is SINGLE else 1e-12, atol=1e-7)


def _id_cases():
    rng = np.random.default_rng(3)
    gaps = np.array([0, 3, 17, 250, 251, 1000])
    yield "gaps", rng.choice(gaps, 5000), rng.choice(gaps, 5000)
    a = rng.integers(0, 40, 3000)
    yield "autocorrelations", a, np.where(rng.random(3000) < 0.3, a,
                                          rng.integers(0, 40, 3000))
    yield "one_pair", np.full(700, 5), np.full(700, 9)
    yield "one_record", np.array([2]), np.array([2])
    yield "none", np.zeros(0, np.int64), np.zeros(0, np.int64)
    a1 = rng.integers(0, 512, 100_000)
    yield "ska_low", a1, np.minimum(a1 + rng.integers(0, 64, 100_000), 511)


CASES = list(_id_cases())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_run_bound_counts_what_np_unique_counts(case, dtype, as_tensor):
    _, a1, a2 = case
    a1, a2 = a1.astype(dtype), a2.astype(dtype)
    n = a1.shape[0]
    args = (torch.as_tensor(a1), torch.as_tensor(a2)) if as_tensor \
        else (a1, a2)
    got = ds.aw_run_bound(*args, n)
    assert type(got) is int
    assert got == _np_bound(a1, a2, n)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pair_count_is_the_cube_s_old_unique_count(case):
    """``aw_idg_cube`` sizes its run bound from :func:`pair_count`; it
    counted the int32 device ids' pair keys with ``torch.unique``, and
    the count, with it ``max_runs``, stays that number."""
    _, a1, a2 = case
    a1_d, a2_d = (torch.as_tensor(a.astype(np.int32)) for a in (a1, a2))
    want = int(torch.unique(a1_d.to(torch.int64) * 2**32
                            + a2_d.to(torch.int64)).numel())
    assert ds.pair_count(a1_d, a2_d) == want


@pytest.fixture(scope="module")
def vd():
    return inputs.vis_data_from_observation(simulate_observation(CFG))


def _parent_inputs(vd, ak, fov_pad, device="cpu"):
    """The host-built inputs: numpy screens cast to complex64 and the
    ``np.unique`` bound."""
    n = vd.vis.shape[0]
    n_t, n_g, _, _ = fov_pad_geometry(THETA, LAM, fov_pad)
    scr = aw_screens_host(ak.astype(np.complex64), 64,
                          fov_scale=n_g / n_t).astype(np.complex64)
    a1, a2 = ds.ant_ids(vd, n)
    return (torch.as_tensor(scr, device=device),
            torch.as_tensor(a1.astype(np.int32), device=device),
            torch.as_tensor(a2.astype(np.int32), device=device),
            _np_bound(a1, a2, n), n)


@pytest.mark.parametrize("fov_pad", [None, 0.75])
def test_image_matches_the_host_built_route(vd, fov_pad):
    ak = _stamps()
    scr, a1, a2, max_runs, n = _parent_inputs(vd, ak, fov_pad)
    uvw, f, vis = ds.idg_inputs(vd, device="cpu")
    layout = ds.detect_time_major_layout(vd.antenna1, vd.antenna2,
                                         vd.time, n)
    img, mx, nd = ds.aw_idg_pipeline(
        scr, uvw, a1, a2, f, vis, theta=THETA, lam=LAM, max_runs=max_runs,
        fov_pad=fov_pad, layout=layout)
    got = ds.aw_idg_image(vd, ak, theta=THETA, lam=LAM, fov_pad=fov_pad,
                          device="cpu")
    assert got.n_dropped == int(nd)
    np.testing.assert_allclose(got.image.numpy(), img.numpy(), rtol=1e-6,
                               atol=1e-6 * float(img.abs().max()))
    assert got.image_max == pytest.approx(float(mx), rel=1e-6)


@pytest.mark.parametrize("fov_pad", [None, 0.75])
def test_prediction_matches_the_host_built_route(vd, fov_pad):
    ak = _stamps()
    model = np.zeros((N, N), np.float32)
    model[N // 2 + 5, N // 2 - 7] = 1.0
    model[N // 2 - 20, N // 2 + 11] = 0.5
    scr, a1, a2, max_runs, n = _parent_inputs(vd, ak, fov_pad)
    uvw, f = ds._uvw_freq(vd, n, SINGLE, "cpu")
    vis, nd = ds.aw_idg_predict_pipeline(
        scr, torch.as_tensor(model), uvw, a1, a2, f, theta=THETA, lam=LAM,
        subgrid=64, taper_beta=12.0, max_runs=max_runs, fov_pad=fov_pad)
    got = ds.aw_predict_vis(vd, ak, model, theta=THETA, lam=LAM,
                            fov_pad=fov_pad, device="cpu")
    assert got.n_dropped == int(nd)
    np.testing.assert_allclose(got.vis.numpy(), vis.numpy(), rtol=1e-6,
                               atol=1e-6 * float(vis.abs().max()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
def test_on_the_card_screens_and_count(cuda):
    ak = np.zeros((512, 15, 15), np.complex128)
    ak[:, 7, 7] = 1.0
    rng = np.random.default_rng(11)
    ak += 0.01 * (rng.standard_normal(ak.shape)
                  + 1j * rng.standard_normal(ak.shape))
    got = aw_screens(torch.as_tensor(ak, device=cuda), 64, 1.25,
                     dtype=torch.complex128)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(),
                               aw_screens_host(ak, 64, 1.25),
                               rtol=1e-12, atol=1e-14)
    scr = ds.antenna_screens(ak, 64, THETA, LAM, None, SINGLE, cuda)
    assert scr.dtype == torch.complex64 and scr.device.type == "cuda"
    np.testing.assert_allclose(
        scr.cpu().numpy(),
        aw_screens_host(ak.astype(np.complex64), 64).astype(np.complex64),
        rtol=1e-6, atol=1e-7)
    a1 = rng.integers(0, 512, 1_046_528)
    a2 = np.minimum(a1 + rng.integers(0, 128, a1.shape[0]), 511)
    n = a1.shape[0]
    got = ds.aw_run_bound(torch.as_tensor(a1.astype(np.int32), device=cuda),
                          torch.as_tensor(a2.astype(np.int32), device=cuda),
                          n)
    assert got == _np_bound(a1, a2, n)
