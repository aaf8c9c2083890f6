"""Host-to-device copies from page-locked caller memory
(``utils/hostmem.py``: ``pinned_copy`` and ``to_device``).

* the registry, through fake register and unregister hooks: a buffer is
  registered on its second sight and never on its first; a view hits its
  buffer's registration; the owner's collection unregisters the buffer
  before its memory is freed; the byte bound evicts the least recently
  used buffer; a failed registration leaves the buffer on the pageable
  path for good, counted in ``COUNTERS``;
* ``to_device`` on the CPU consults no registry and gives the host cast's
  tensors bit for bit; the registered branch counts ``h2d_bytes``,
  ``h2d_registered_bytes`` (summed up to the root span) and
  ``h2d/registered``;
* the casts the card makes equal numpy's bit for bit, here on CPU torch:
  float64 → float32 (large, halfway and subnormal values), int64 → int32,
  complex128 → complex64, a strided view through its span;
* on the card (``cuda``): ``idg_image``, ``aw_idg_image``, ``aw_image``
  and ``w_image`` make the same device inputs bit for bit from registered
  memory as from the pageable path, and images within float32
  summation-order noise of the pageable path's, on the benchmark's
  SKA1-Low shapes cut to one dump; the registered view reads
  ``is_pinned()``, and the registered share of the bytes copied is
  ≥ 0.99 from the second call on.
"""

import array
import gc
import json
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch.models import dataset as ds
from ska_sdp_tpu_torch.types import SINGLE
from ska_sdp_tpu_torch.utils import hostmem, timing

ROOT = Path(__file__).resolve().parents[1]


class Hooks:
    """Fake ``register`` / ``unregister`` hooks that log their calls."""

    def __init__(self, ok=True):
        self.ok = ok
        self.calls = []

    def register(self, ptr, size):
        self.calls.append(("register", ptr, size))
        return self.ok

    def unregister(self, ptr):
        self.calls.append(("unregister", ptr))


def _registry(hooks, bound=1 << 30):
    return hostmem.HostRegistry(hooks.register, hooks.unregister, bound)


def _sight(reg, x):
    return reg.pinned(x, *hostmem._bounds(x))


def _count(key):
    return timing.COUNTERS.get(f"h2d/{key}", 0)


def test_first_sight_is_not_registered_the_second_is():
    hooks = Hooks()
    reg = _registry(hooks)
    a = np.arange(1000.0)
    before = _count("register")
    assert not _sight(reg, a)
    assert hooks.calls == []
    assert _sight(reg, a)
    assert hooks.calls == [("register", a.ctypes.data, a.nbytes)]
    assert _sight(reg, a)
    assert len(hooks.calls) == 1
    assert reg.bytes == a.nbytes
    assert _count("register") == before + 1


def test_a_view_hits_its_buffers_registration():
    hooks = Hooks()
    reg = _registry(hooks)
    uvw = np.zeros((1000, 3))
    assert not _sight(reg, uvw[:10])            # a view: its buffer's sight
    assert _sight(reg, uvw[500:700])            # the buffer's second
    assert hooks.calls == [("register", uvw.ctypes.data, uvw.nbytes)]
    assert _sight(reg, uvw[:, 2])
    assert _sight(reg, uvw)
    assert len(hooks.calls) == 1
    # bytes outside the buffer are not in its registration
    lo, hi = hostmem._bounds(uvw)
    assert not reg.pinned(uvw, lo, hi + 8)


def test_the_owners_collection_unregisters_before_free():
    order = []
    reg = hostmem.HostRegistry(lambda p, s: True,
                               lambda p: order.append(("unregister", p)))
    owner = array.array("d", range(4096))      # owns the memory
    weakref.finalize(owner, order.append, "freed")
    a = np.frombuffer(owner, np.float64)        # the buffer, over it
    ptr = a.ctypes.data
    del owner
    assert not _sight(reg, a[:10])
    assert _sight(reg, a[10:])
    assert reg.bytes == a.nbytes
    del a
    gc.collect()
    assert order == [("unregister", ptr), "freed"]
    assert reg.bytes == 0


def test_a_buffer_seen_once_is_forgotten_with_its_owner():
    hooks = Hooks()
    reg = _registry(hooks)
    a = np.ones(100)
    assert not _sight(reg, a)
    assert len(reg._state) == 1
    del a
    gc.collect()
    assert reg._state == {} and hooks.calls == []


def test_the_byte_bound_evicts_the_least_recently_used():
    hooks = Hooks()
    reg = _registry(hooks, bound=3 * 8000)
    a, b, c, d = (np.zeros(1000) for _ in range(4))   # 8000 bytes each
    for x in (a, b, c):
        _sight(reg, x)
        assert _sight(reg, x)
    assert reg.bytes == 3 * 8000
    assert _sight(reg, a)                       # a: most recent, b: least
    assert not _sight(reg, d)
    assert _sight(reg, d)                       # evicts b
    assert hooks.calls[-2:] == [("unregister", b.ctypes.data),
                                ("register", d.ctypes.data, d.nbytes)]
    assert reg.bytes == 3 * 8000
    assert all(_sight(reg, x) for x in (a, c, d))
    assert _sight(reg, b)                       # seen again: evicts a
    assert hooks.calls[-2][1] == a.ctypes.data
    # a buffer larger than the bound is never registered
    big = np.zeros(4000)
    _sight(reg, big)
    n = len(hooks.calls)
    assert not _sight(reg, big) and len(hooks.calls) == n


def test_a_failed_registration_falls_back_for_good(monkeypatch):
    hooks = Hooks(ok=False)
    reg = _registry(hooks)
    monkeypatch.setattr(hostmem, "REGISTRY", reg)
    uvw = np.random.default_rng(3).normal(size=(500, 3)) * 1e4
    before = {k: _count(k) for k in ("register", "register_failed")}
    got = [hostmem.pinned_copy(uvw, "cpu") for _ in range(4)]
    assert got == [None] * 4
    assert hooks.calls == [("register", uvw.ctypes.data, uvw.nbytes)]
    assert _count("register_failed") == before["register_failed"] + 1
    assert _count("register") == before["register"]
    # the caller's pageable path: the host cast's tensor
    t = hostmem.to_device(uvw, "cpu", np_dtype=np.float32)
    assert np.array_equal(t.numpy().view(np.int32),
                          np.ascontiguousarray(uvw, np.float32).view(np.int32))


@pytest.mark.parametrize("np_dtype, dtype", [
    (np.float32, None), (np.int32, None), (np.complex64, None),
    (None, torch.float32), (None, None)])
def test_the_cpu_never_registers_and_keeps_the_host_cast(monkeypatch,
                                                         np_dtype, dtype):
    hooks = Hooks()
    reg = _registry(hooks)
    monkeypatch.setattr(hostmem, "REGISTRY", reg)
    rng = np.random.default_rng(5)
    src = {np.int32: np.arange(-500, 500, dtype=np.int64),
           np.complex64: rng.normal(size=600) + 1j * rng.normal(size=600)}
    x = src.get(np_dtype, rng.normal(size=(200, 3)) * 1e5)
    before = dict(timing.COUNTERS.group("h2d/"))
    for view in (x, x[: len(x) // 2], x[::2]):
        for _ in range(3):
            t = hostmem.to_device(view, "cpu", np_dtype=np_dtype, dtype=dtype)
            ref = torch.as_tensor(
                view if np_dtype is None
                else np.ascontiguousarray(view, np_dtype), dtype=dtype)
            assert t.dtype == ref.dtype and t.shape == ref.shape
            assert t.stride() == ref.stride()
            assert t.numpy().tobytes() == ref.numpy().tobytes()
    assert hooks.calls == [] and reg._state == {}
    assert dict(timing.COUNTERS.group("h2d/")) == before


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({4: np.uint32, 8: np.uint64}[a.itemsize])


def test_the_cards_casts_equal_numpys():
    tiny = np.float64(np.finfo(np.float32).smallest_subnormal)
    f64 = np.array([
        0.0, -0.0, 1.0, -1.0, np.pi, 1e300, -1e300, 3.4028235677973366e38,
        3.4028235677973362e38, 3.402823669209385e38, 1e39, np.inf, -np.inf,
        1 + 2.0 ** -24, 1 + 3 * 2.0 ** -24, -(1 + 5 * 2.0 ** -24),
        2.0 ** -126 * (1 + 2.0 ** -24), tiny, tiny / 2, 3 * tiny / 2,
        tiny / 2 * (1 + 2.0 ** -20), 1e-40, -1e-42, 1e-46, 2.0 ** -150,
        5e-324, 65432.10987654321, 1234567.8901234567])
    rng = np.random.default_rng(7)
    f64 = np.concatenate([f64, rng.normal(size=4096) * 10.0 ** rng.integers(
        -45, 39, 4096)])
    with np.errstate(over="ignore"):
        want = f64.astype(np.float32)
    got = torch.from_numpy(f64).to(torch.float32).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    i64 = np.concatenate([np.array([0, -1, 2**31 - 1, -2**31, 511, 1]),
                          rng.integers(-2**31, 2**31, 4096)]).astype(np.int64)
    assert np.array_equal(torch.from_numpy(i64).to(torch.int32).numpy(),
                          i64.astype(np.int32))
    c128 = np.empty(len(f64) // 2, np.complex128)
    c128.real, c128.imag = f64[:len(c128)], f64[len(c128):2 * len(c128)]
    with np.errstate(over="ignore"):
        cwant = c128.astype(np.complex64)
    cgot = torch.from_numpy(c128).to(torch.complex64).numpy()
    assert np.array_equal(_bits(cgot.view(np.float32)),
                          _bits(cwant.view(np.float32)))


def test_a_strided_view_is_copied_through_its_span(monkeypatch):
    hooks = Hooks()
    monkeypatch.setattr(hostmem, "REGISTRY", _registry(hooks))
    rng = np.random.default_rng(11)
    stamps = rng.normal(size=(64, 2, 2, 15, 15)) \
        + 1j * rng.normal(size=(64, 2, 2, 15, 15))
    view = stamps[:, 0, 0]                      # what a caller hands over
    assert hostmem.pinned_copy(view, "cpu") is None       # first sight
    t, nbytes = hostmem.pinned_copy(view, "cpu")
    lo, hi = hostmem._bounds(view)
    assert nbytes == hi - lo < view.nbytes * hostmem._SPAN_RATIO
    assert t.is_contiguous() and t.shape == view.shape
    assert np.array_equal(t.numpy(), view)
    c64 = t.to(torch.complex64).numpy()
    assert np.array_equal(c64, np.ascontiguousarray(view, np.complex64))
    # a span of more than _SPAN_RATIO times the bytes: the pageable path
    assert hostmem.pinned_copy(stamps[:, 0, 0, 7, 7], "cpu") is None
    assert hostmem.pinned_copy(view[::-1], "cpu") is None


def test_the_registered_branch_counts_up_to_the_root(monkeypatch):
    """``to_device``'s registered branch, with the copy faked on the CPU:
    raw bytes counted in ``h2d_bytes`` and ``h2d_registered_bytes`` of
    every open span, the cast after the copy."""
    def fake(x, device):
        return torch.from_numpy(np.ascontiguousarray(x)).clone(), x.nbytes

    monkeypatch.setattr(hostmem, "pinned_copy", fake)
    card = torch.device("cuda")
    uvw = np.random.default_rng(2).normal(size=(300, 3)) * 1e4
    ids = np.arange(300, dtype=np.int64)
    before = _count("registered")
    vd = ds.VisData(None, uvw, ids, ids, None, 1.0)
    timing.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with ds._entry("fake", vd, None):
            with timing.span("sdp.host_prep"):
                u = hostmem.to_device(uvw, card, np_dtype=np.float32)
                a = hostmem.to_device(ids, card, np_dtype=np.int32)
    log = timing.spans()
    root = next(s for s in log if s.parent is None)
    prep = next(s for s in log if s.name == "sdp.host_prep")
    want = uvw.nbytes + ids.nbytes
    assert root.counts == {"records": 300, "h2d_bytes": want,
                           "h2d_registered_bytes": want}
    assert prep.counts == {"h2d_bytes": want, "h2d_registered_bytes": want}
    assert _count("registered") == before + 2
    assert u.dtype == torch.float32 and a.dtype == torch.int32
    assert np.array_equal(u.numpy(), uvw.astype(np.float32))
    assert np.array_equal(a.numpy(), ids.astype(np.int32))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


CELLS = {"idg_image": "ska1low-idg", "aw_idg_image": "ska1low-idg",
         "aw_image": "ska1low-aw", "w_image": "ska1low-wproj"}


def _one_dump(config: str, device):
    """The entry's arguments on the benchmark's SKA1-Low shapes, one dump
    (130,816 records), as its harness hands them over: uvw float64, ids
    int64, visibilities complex64, the stamps a strided view."""
    from benchmark import observation as obsgen
    from benchmark.wbank import w_bank

    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / f"{config}.json").read_text())
    cfg["observation"]["dumps"] = 1
    st = cfg["settings"]
    ocfg = obsgen.from_config(cfg, 5, 2147483659)
    obs = obsgen.simulate_observation(ocfg)
    vis = obsgen.sky(obs, ocfg, 0, device)[1]
    vd = ds.VisData(vis, obs["uvw"], obs["antenna1"], obs["antenna2"],
                    obs["time"], float(obs["frequency"][0]))
    kw = {k: st[k] for k in cfg["entry_kwargs"]}
    akerns = obsgen.akern_stamps(cfg["telescope"]["stations"],
                                 ocfg.akern_size, 2147483659)[:, 0, 0]
    if "nw_planes" not in st:
        return vd, [akerns], kw
    centers = obsgen.w_plane_centers(obs, st["nw_planes"])
    bank = w_bank(st["theta"], centers, st["qpx"], st["npix_ff"],
                  st["support"], device=device)
    return vd, [bank, centers] + ([akerns] if config == "ska1low-aw"
                                  else []), kw


def _inputs_on_card(name, vd, extra, device):
    """The device tensors the entry makes of its host arrays."""
    prec = SINGLE
    out = list(ds.idg_inputs(vd, device=device))
    if name.startswith("aw_"):
        out.append(ds.stamp_tensors(extra[-1], prec, device))
        out += ds.id_tensors(ds.ant_ids(vd, len(vd.uvw)), device)
    if name == "aw_image" or name == "w_image":
        out += list(ds.bank_tensors(extra[0], extra[1], prec, device))
    return out


def _central_rel_l2(a, b, frac):
    """Relative L2 distance of ``a`` from ``b`` over the central ``frac``
    of the image's side, in float64."""
    n = a.shape[0]
    lo, hi = int(n * (1 - frac) / 2), int(n * (1 + frac) / 2)
    a, b = (x[lo:hi, lo:hi].double() for x in (a, b))
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_on_the_card_registered_inputs_are_the_pageable_ones(
        name, cuda, monkeypatch):
    """The entry's device inputs are bit for bit the pageable path's.  Its
    images are not bit for bit even between two pageable calls (float
    atomics in the gridders; IDG's division by the taper magnifies the
    edges), so they are held within float32 summation-order noise: IDG
    over the central 75% (the accurate field), the others whole."""
    vd, extra, kw = _one_dump(CELLS[name], cuda)
    entry = getattr(ds, name)
    args = [vd] + (extra if name != "idg_image" else [])

    monkeypatch.setattr(hostmem, "REGISTRY",
                        hostmem.HostRegistry(lambda p, s: False))
    want = _inputs_on_card(name, vd, extra, cuda)
    pageable = entry(*args, **kw, device=cuda).image
    monkeypatch.setattr(hostmem, "REGISTRY", hostmem.HostRegistry())
    assert not torch.from_numpy(vd.uvw).is_pinned()
    entry(*args, **kw, device=cuda)             # first sight
    for _ in range(2):
        timing.clear_spans()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            img = entry(*args, **kw, device=cuda).image
        root = next(s for s in timing.spans() if s.parent is None)
        share = root.counts["h2d_registered_bytes"] / root.counts["h2d_bytes"]
        assert share >= 0.99, root.counts
        frac = 0.75 if "idg" in name else 1.0
        assert _central_rel_l2(img, pageable, frac) < 1e-5
    got = _inputs_on_card(name, vd, extra, cuda)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.is_contiguous()
        assert g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes()
    assert torch.from_numpy(vd.uvw[1000:2000]).is_pinned()
    if name.startswith("aw_"):
        assert torch.from_numpy(vd.antenna1[:500]).is_pinned()
