"""The readers of the program's span log (``host_prep_ms``,
``host_issue_ms``, ``host_wait_ms``, ``h2d_gbps``, ``issue_prep_ms``,
``issue_kernel_ms``, ``issue_finish_ms``) on a built log: their values,
roots that are no entry's passed over, and None where the log holds
another number of entry roots than the traced pass had requests, or no
log at all."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.tests.conftest import BENCH
from ska_sdp_tpu_torch.utils import timing

MS = 1_000_000                        # nanoseconds a millisecond
NAMES = ("host_prep_ms", "host_issue_ms", "host_wait_ms", "h2d_gbps",
         "issue_prep_ms", "issue_kernel_ms", "issue_finish_ms")


def _request(i0, t0, prep_ms, wait_ms, total_ms, h2d_bytes):
    """A root and its spans: host prep from t0 (a cast inside), 1 ms of
    device prep (a nested device prep inside), 1 ms of kernel, 2 ms of
    finish, two readbacks of wait_ms/2 at the end; ids from i0."""
    rid = i0
    t1 = t0 + prep_ms * MS
    spans = [
        timing.SpanRecord(i0 + 1, i0 + 2, rid, "sdp.host_prep.cast", t0,
                          t0 + MS // 2, {}),
        timing.SpanRecord(i0 + 2, rid, rid, "sdp.host_prep", t0, t1, {}),
        timing.SpanRecord(i0 + 3, i0 + 4, rid, "sdp.device_prep", t1,
                          t1 + MS // 2, {}),
        timing.SpanRecord(i0 + 4, rid, rid, "sdp.device_prep", t1, t1 + MS,
                          {}),
        timing.SpanRecord(i0 + 5, rid, rid, "sdp.kernel.idg_grid", t1 + MS,
                          t1 + 2 * MS, {}),
        timing.SpanRecord(i0 + 6, rid, rid, "sdp.finish", t1 + 2 * MS,
                          t1 + 4 * MS, {}),
    ]
    end = t0 + total_ms * MS
    half = wait_ms * MS // 2
    spans += [timing.SpanRecord(i0 + 7, rid, rid, "sdp.readback",
                                end - 2 * half, end - half, {}),
              timing.SpanRecord(i0 + 8, rid, rid, "sdp.readback",
                                end - half, end, {})]
    spans.append(timing.SpanRecord(rid, None, rid, "sdp.idg_image", t0, end,
                                   {"records": 10, "h2d_bytes": h2d_bytes}))
    return spans


def _orphan(i, t0):
    """A root that is no entry's: a host helper's span logged outside an
    entry (as the entries without a root span log them)."""
    return [timing.SpanRecord(i, None, i, "sdp.host_prep.cast", t0,
                              t0 + MS, {}),
            timing.SpanRecord(i + 1, None, i + 1, "sdp.kernel.wproj_grid",
                              t0 + MS, t0 + 2 * MS, {})]


def _measurement(n, h2d_s):
    prof = [SimpleNamespace(device={"h2d": h2d_s}) for _ in range(n)]
    return SimpleNamespace(trace=SimpleNamespace(), profiled=prof)


@pytest.fixture
def readers():
    return {n: harness.load_metric(BENCH, n) for n in NAMES}


def test_values_from_a_built_log(readers, monkeypatch):
    # two traced requests, with roots of no entry before and between
    log = (_orphan(100, 0)
           + _request(200, 10 * MS, 4, 2, 20, 3_000_000)
           + _orphan(250, 35 * MS)
           + _request(300, 40 * MS, 6, 6, 30, 5_000_000))
    monkeypatch.setattr(timing, "spans", lambda: list(log))
    m = _measurement(2, 0.002)
    got = {n: readers[n](m) for n in NAMES}
    assert got["host_prep_ms"] == pytest.approx((4 + 6) / 2)
    assert got["host_wait_ms"] == pytest.approx((2 + 6) / 2)
    assert got["host_issue_ms"] == pytest.approx(((20 - 4 - 2)
                                                  + (30 - 6 - 6)) / 2)
    # 8 MB over 4 ms of copies on the card
    assert got["h2d_gbps"] == pytest.approx(8e6 / 0.004 / 1e9)
    # the split of the issue time, a nested span counted once
    assert got["issue_prep_ms"] == pytest.approx(1)
    assert got["issue_kernel_ms"] == pytest.approx(1)
    assert got["issue_finish_ms"] == pytest.approx(2)


@pytest.mark.parametrize("n_requests", [1, 3])
def test_none_on_a_count_mismatch(readers, monkeypatch, n_requests):
    log = (_request(100, 0, 4, 2, 20, 3_000_000) + _orphan(150, 25 * MS)
           + _request(200, 30 * MS, 4, 2, 20, 3_000_000))
    monkeypatch.setattr(timing, "spans", lambda: list(log))
    m = _measurement(n_requests, 0.002)
    assert all(readers[n](m) is None for n in NAMES)


def test_none_without_copies_on_the_card_or_a_trace(readers, monkeypatch):
    log = _request(200, 0, 4, 2, 20, 3_000_000)
    monkeypatch.setattr(timing, "spans", lambda: list(log))
    assert readers["h2d_gbps"](_measurement(1, 0.0)) is None
    assert readers["host_prep_ms"](_measurement(1, 0.0)) == pytest.approx(4)
    untraced = SimpleNamespace(trace=None, profiled=[])
    assert all(readers[n](untraced) is None for n in NAMES)


def test_none_from_a_program_without_spans(readers, monkeypatch):
    # a program built before the span log: its timing module has no spans
    monkeypatch.setitem(sys.modules, "ska_sdp_tpu_torch.utils.timing",
                        SimpleNamespace())
    assert all(readers[n](_measurement(1, 0.001)) is None for n in NAMES)
