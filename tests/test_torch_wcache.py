"""PSF-normalised w-cache imaging (``models.dataset.psf_image``, mode
``wcache``) against the benchmark's plain reference
(``benchmark/reference/psf.py``), on the CPU at a test size: a seeded
SKA1-Low-like observation of 8 stations on a 256² grid, w binned by 50
wavelengths over a fixed range of ±100 (5 planes of the default kernel
shape: qpx 8, a 256² far field, support 15).

Both synthesise the planes from the same formula in float32 and scatter
in float32, so they differ by float32 rounding at most; the tolerance,
1e-5, sits well below what rounding the products' operands to TF32 gives
(~3e-4), so the control fails it, and so does the program with its
kernels left unconjugated.  With no range, the bins span the data's own
extent, read back once, and the image is the one the same data gives with
that extent as its range, bit for bit.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import observation as obsgen  # noqa: E402
from benchmark.reference import common, psf  # noqa: E402
from ska_sdp_tpu_torch.config import KernelOptions  # noqa: E402
from ska_sdp_tpu_torch.models import dataset as ds  # noqa: E402
from ska_sdp_tpu_torch.models import imaging  # noqa: E402
from ska_sdp_tpu_torch.ops import mirror_uvw, uvw_lambda  # noqa: E402
from ska_sdp_tpu_torch.utils import timing  # noqa: E402

torch.set_num_threads(2)

THETA, LAM = 0.05, 5120            # a 256² grid
WSTEP, W_RANGE = 50, (-100, 100)
TOL = 1e-5
CPU = torch.device("cpu")
CFG = {"telescope": {"stations": 8, "core_stations": 2,
                     "core_diameter_m": 200.0, "cluster_size": 2, "arms": 3,
                     "cluster_spread_m": 20.0, "arm_twist_rad": 0.5,
                     "max_baseline_m": 4000.0, "height_sigma_m": 5.0,
                     "latitude_deg": -26.8},
       "observation": {"freq_hz": 150e6, "channels": 1, "dump_s": 0.9,
                       "dumps": 4, "declination_deg": -30.0,
                       "hour_angle_deg": 0.0},
       "settings": {"theta": THETA}}
SETTINGS = {"theta": THETA, "lam": LAM, "wstep": WSTEP,
            "w_range": list(W_RANGE), "qpx": 8, "npix_ff": 256,
            "support": 15}


@pytest.fixture(scope="module")
def case():
    oc = obsgen.from_config(CFG, 5, 2**31 + 41)
    obs = obsgen.simulate_observation(oc)
    _, vis = obsgen.sky(obs, oc, 0)
    req = {"uvw": obs["uvw"], "vis": vis, "a1": obs["antenna1"],
           "a2": obs["antenna2"], "time": obs["time"],
           "freq": float(obs["frequency"][0])}
    return req, psf.image(req, SETTINGS, CPU)


def _vd(req):
    return ds.VisData(req["vis"], req["uvw"], req["a1"], req["a2"],
                      req["time"], req["freq"])


def _program(req, **kw):
    kw = dict(dict(theta=THETA, lam=LAM, wstep=WSTEP, w_range=W_RANGE,
                   device="cpu"), **kw)
    return ds.psf_image(_vd(req), "wcache", **kw)


def _gap(img, ref) -> float:
    d = img.double() - ref.double()
    return float(torch.linalg.vector_norm(d)
                 / torch.linalg.vector_norm(ref.double()))


def test_program_matches_the_reference(case):
    req, ref = case
    # the snapshot's w reaches past one bin but not past the range
    w = np.abs(req["uvw"][:, 2]) * req["freq"] / common.C
    assert WSTEP < w.max() < W_RANGE[1]
    assert psf.planes(SETTINGS) == 5
    res = _program(req)
    assert _gap(res.image, ref["image"]) < TOL
    assert _gap(res.psf, ref["psf"]) < TOL
    assert abs(float(res.pmax) / float(ref["pmax"]) - 1) < 1e-5


def test_tf32_operands_fail_the_tolerance(case):
    req, ref = case
    ctl = psf.image(req, SETTINGS, CPU, common.tf32)
    assert _gap(ctl["image"], ref["image"]) > TOL


def test_unconjugated_kernels_fail_the_tolerance(case, monkeypatch):
    req, ref = case
    real = imaging.w_kernel_bank

    def unconjugated(*a, **k):
        return torch.conj(real(*a, **k)).resolve_conj()
    monkeypatch.setattr(imaging, "w_kernel_bank", unconjugated)
    assert _gap(_program(req).image, ref["image"]) > TOL


def test_no_range_is_the_datas_own_extent(case):
    """``w_range=None``: the bins of the rounded extent, the minimum and
    maximum read in one readback as the host's ``float()`` of each read
    them before; the image equal, bit for bit, to the one with that
    extent given as the range and to ``do_imaging`` through the imaging
    function the mode bound before ranges existed."""
    req, _ = case
    vd = _vd(req)
    f = torch.tensor(vd.frequency, dtype=torch.float32)
    uvw0 = uvw_lambda(f, torch.as_tensor(np.asarray(vd.uvw, np.float32)))
    vis = torch.as_tensor(np.asarray(vd.vis, np.complex64))
    uvw1, _ = mirror_uvw(uvw0, vis)           # do_imaging bins these
    centres, wbin = imaging.w_cache_bins(uvw1, WSTEP)
    roundedw = WSTEP * torch.round(uvw1[:, 2] / WSTEP)
    lo, hi = float(roundedw.min()), float(roundedw.max())
    assert np.array_equal(centres, lo + WSTEP * np.arange(
        int((hi - lo) // WSTEP) + 1, dtype=np.float64))
    assert torch.equal(wbin, ((roundedw.to(torch.float64) - lo)
                              // WSTEP).to(torch.int32))

    free = _program(req, w_range=None)
    assert torch.equal(free.image, _program(req, w_range=(lo, hi)).image)
    old = imaging.do_imaging(
        THETA, LAM, uvw0, torch.as_tensor(vd.antenna1),
        torch.as_tensor(vd.antenna2), torch.as_tensor(vd.time),
        vd.frequency, vis, functools.partial(
            imaging.w_cache_imaging, opts=KernelOptions(wstep=WSTEP)))
    assert torch.equal(free.image, old.image)
    assert torch.equal(free.psf, old.psf)


@pytest.mark.parametrize("mode", ["simple", "conv"])
def test_a_range_outside_wcache_is_refused(case, mode):
    req, _ = case
    with pytest.raises(ValueError, match="w_range"):
        ds.psf_image(_vd(req), mode, theta=THETA, lam=LAM, w_range=W_RANGE,
                     device="cpu")


@pytest.mark.parametrize("mode, planes", [("wcache", 2 * 5), ("conv", 0)])
def test_the_synthesis_counts_its_planes(case, mode, planes):
    """The root's ``wkernel_planes``: a bank for the image and another for
    the PSF in ``wcache``; none in ``conv``, whose one kernel is bound
    once, outside the w-cache."""
    req, _ = case
    kw = {} if mode == "wcache" else {"w_range": None}
    timing.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ds.psf_image(_vd(req), mode, **dict(
            dict(theta=THETA, lam=LAM, wstep=WSTEP, w_range=W_RANGE,
                 device="cpu"), **kw))
    root, = [s for s in timing.spans() if s.parent is None]
    assert root.name == "sdp.psf_image"
    assert root.counts["wkernel_planes"] == planes
    assert root.counts["wkernel_bytes"] == planes * 2048 ** 2 * 8
