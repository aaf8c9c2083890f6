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

The synthesis's pruned transform (``ops.wkernel.tap_window``): its plain
version equals the padded transform that ``w_kernel`` keeps on the CPU in
float64, an odd ``npix_ff·qpx`` included; on the card
(``cuda``-marked, no JAX imported here) ``csrc/wkernel_synth.cu`` against
both at the cell's bank shape and against the plain version at shapes
that take its other routes, and the w-cache image and PSF against the
CPU's within the cell's committed limits.
"""

import functools
import json
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
from ska_sdp_tpu_torch.kernels import wkernel_synth as synth  # noqa: E402
from ska_sdp_tpu_torch.models import dataset as ds  # noqa: E402
from ska_sdp_tpu_torch.models import imaging  # noqa: E402
from ska_sdp_tpu_torch.ops import (ifft_centered, mirror_uvw,  # noqa: E402
                                   pad_mid, uvw_lambda)
from ska_sdp_tpu_torch.ops import wkernel  # noqa: E402
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
    assert root.counts["wkernel_bytes"] == planes * 256 ** 2 * 8


# ---- the pruned transform -------------------------------------------------
# (npix_ff, qpx, support, pattern options): the cell's shape; shapes whose
# tap rows are no multiple of the kernel's column tile, with the pattern
# transforms (whole-unit shifts put every screen point past the horizon);
# an odd npix_ff·qpx
SHAPES = [(256, 8, 15, {}),
          (64, 4, 7, dict(pat_trans_mat=(0.9, 0.2, -0.1, 1.1))),
          (50, 3, 9, dict(pat_trans_mat=(0.0, 1.0, 1.0, 0.0))),
          (45, 3, 9, dict(pat_trans_mat=(0.9, 0.2, -0.1, 1.1)))]
CELL = dict(theta=0.054, w=(-1920.0, 1920.0), planes=33)
CARD_TOL = {torch.complex64: 2e-6, torch.complex128: 1e-12}


def _screens(shape, w, theta=0.054, dtype=torch.float64, device=CPU):
    n0, qpx, s, kw = shape
    opts = KernelOptions(qpx=qpx, npix_ff=n0, npix_kern=s, **kw)
    l, m = wkernel.kernel_coordinates(n0, theta, opts, dtype=dtype,
                                      device=device)
    return wkernel.w_kernel_function(
        l, m, torch.as_tensor(w, dtype=dtype, device=device)), opts


def _tap_gap(got, want) -> float:
    d = got.to(torch.complex128) - want.to(torch.complex128)
    return float(torch.linalg.vector_norm(d)
                 / torch.linalg.vector_norm(want.to(torch.complex128)))


def _padded(ff, opts):
    """The CPU's route: pad, centred inverse FFT, extract."""
    return wkernel.extract_oversampled(
        ifft_centered(pad_mid(ff, opts.npix_ff * opts.qpx)), opts.qpx,
        opts.npix_kern)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_taps_are_the_padded_transform(shape):
    ff, opts = _screens(shape, [-1920.0, 0.0, 700.0, 1920.0])
    got = wkernel.w_kernel_taps_plain(ff, opts.qpx, opts.npix_kern)
    want = _padded(ff, opts)
    assert got.shape == want.shape == (4, opts.qpx, opts.qpx,
                                       opts.npix_kern, opts.npix_kern)
    assert _tap_gap(got, want) < 1e-12
    # the CPU's w_kernel keeps the padded route, conjugated on request
    w = torch.tensor([-1920.0, 0.0, 700.0, 1920.0], dtype=torch.float64)
    assert torch.equal(wkernel.w_kernel(0.054, w, opts), want)
    assert torch.equal(wkernel.w_kernel_bank(0.054, w, opts),
                       want.conj().resolve_conj())
    assert torch.equal(wkernel.w_kernel_taps_plain(ff, opts.qpx,
                                                   opts.npix_kern, conj=True),
                       got.conj().resolve_conj())


@pytest.mark.parametrize("call, match", [
    (lambda: synth.wkernel_synth(torch.zeros((2, 64, 64), dtype=torch.complex64),
                                 4, 7), "CUDA"),
    (lambda: synth.wkernel_synth(torch.zeros((2, 63, 64), dtype=torch.complex64),
                                 3, 7), "n0, n0"),
    (lambda: synth.wkernel_synth(torch.zeros((2, 16, 16), dtype=torch.complex64),
                                 2, 17), "outside"),
    (lambda: synth.wkernel_synth(torch.zeros((64, 64), dtype=torch.complex64),
                                 4, 7), "n0, n0"),
    (lambda: synth.wkernel_synth(torch.zeros((2, 64, 64)), 4, 7), "complex"),
    (lambda: wkernel.w_kernel_taps_plain(
        torch.zeros((1, 4, 4), dtype=torch.complex128), 2, 7), "outside"),
])
def test_the_kernel_wrapper_raises(call, match):
    """It launches or raises: the CPU takes ``w_kernel``'s padded route,
    never the wrapper; taps past the padded plane, screens that are not a
    stack of squares and other dtypes are refused before any launch."""
    with pytest.raises(ValueError, match=match):
        call()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("real", [torch.float32, torch.float64])
def test_kernel_matches_plain_and_padded_on_card(cuda, real, conj):
    """The cell's bank (33 planes over ±1,920 λ, 256/8/15): within 2e-6
    (complex64) or 1e-12 (complex128) of the plain version and of the
    padded cuFFT route on the card, the conjugated taps the taps'
    conjugate bit for bit; one launch a bank."""
    w = np.linspace(*CELL["w"], CELL["planes"])
    ff, opts = _screens(SHAPES[0], w, CELL["theta"], real, cuda)
    synth.reset_launch_count()
    got = synth.wkernel_synth(ff, opts.qpx, opts.npix_kern, conj=conj)
    assert synth.launch_count() == 1
    plain = wkernel.w_kernel_taps_plain(ff, opts.qpx, opts.npix_kern)
    lib = _padded(ff, opts)
    if conj:
        plain, lib = plain.conj(), lib.conj()
        assert torch.equal(got, synth.wkernel_synth(
            ff, opts.qpx, opts.npix_kern).conj().resolve_conj())
    tol = CARD_TOL[got.dtype]
    assert got.shape == (CELL["planes"], 8, 8, 15, 15)
    assert _tap_gap(got, plain) < tol
    assert _tap_gap(got, lib) < tol


# (npix_ff, qpx, support, pattern options, real dtype, rel-L2 bound) of the
# kernel's other routes, against the plain version on the CPU in float64
# on the same screens
ROUTES = [
    # 28 tap rows: a ragged column tile, with a pattern transform
    (64, 4, 7, dict(pat_trans_mat=(0.9, 0.2, -0.1, 1.1)), torch.float64,
     1e-12),
    # 136 tap rows: two row tiles, the second of 8 rows
    (64, 8, 17, {}, torch.float64, 1e-12),
    # an odd N = 189
    (63, 3, 7, dict(pat_trans_mat=(0.9, 0.2, -0.1, 1.1)), torch.float64,
     1e-12),
    # 272 tap rows: three row tiles
    (64, 16, 17, {}, torch.float64, 1e-12),
    # N = 8192: a complex128 table beyond shared memory, in device memory
    (1024, 8, 7, {}, torch.float64, 1e-12),
    # N = 67584: a complex64 table in device memory, phase-index products
    # past 32 bits
    (2048, 33, 7, {}, torch.float32, 2e-5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ROUTES)
def test_kernel_at_another_shape_on_card(cuda, shape):
    """Through ``w_kernel`` and ``w_kernel_bank`` on the card against the
    plain version on the CPU in float64 on the same screens: ragged
    column tiles, several row tiles, an odd N, and twiddle tables too large
    for shared memory in both precisions; a scalar ``w`` too."""
    n0, qpx, s, kw, real, tol = shape
    opts = KernelOptions(qpx=qpx, npix_ff=n0, npix_kern=s, **kw)
    w = torch.linspace(-300.0, 300.0, 3, dtype=real)
    l, m = wkernel.kernel_coordinates(n0, 0.1, opts, dtype=real,
                                      device=cuda)
    ff = wkernel.w_kernel_function(l, m, w.to(cuda))
    want = wkernel.w_kernel_taps_plain(ff.cpu().to(torch.complex128), qpx,
                                       s)
    got = wkernel.w_kernel(0.1, w.to(cuda), opts, dtype=real, device=cuda)
    assert got.shape == (3, qpx, qpx, s, s)
    assert _tap_gap(got.cpu(), want) < tol
    got_b = wkernel.w_kernel_bank(0.1, w.to(cuda), opts, dtype=real,
                                  device=cuda)
    assert torch.equal(got_b, got.conj().resolve_conj())
    one = wkernel.w_kernel(0.1, 120.0, opts, dtype=real, device=cuda)
    assert one.shape == (qpx, qpx, s, s)
    ff_one = wkernel.w_kernel_function(l, m, 120.0)
    assert _tap_gap(one.cpu(), wkernel.w_kernel_taps_plain(
        ff_one.cpu().to(torch.complex128), qpx, s)) < tol


@pytest.mark.cuda
def test_card_image_within_the_cells_limits(case, cuda):
    """``psf_image`` (wcache) on the card, its banks from the kernel,
    against the CPU's padded route: the image and the PSF within the cell
    ``wcache.psf``'s committed limits (``benchmark/limits``); two
    syntheses, one a bank."""
    req, _ = case
    limits = json.loads((ROOT / "benchmark" / "limits"
                         / "wcache.psf.json").read_text())
    cpu = _program(req)
    timing.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        card = _program(req, device="cuda")
    root, = [s for s in timing.spans() if s.parent is None]
    assert root.counts["wkernel_planes"] == 2 * 5
    assert root.counts["wkernel_bytes"] == 2 * 5 * 256 ** 2 * 8
    for out in ("image", "psf"):
        got, want = getattr(card, out).cpu().double(), getattr(cpu, out).double()
        assert _gap(got, want) < limits[f"{out}_rel_l2"]
        assert float((got - want).abs().max() / want.abs().max()) \
            < limits[f"{out}_max_err"]
