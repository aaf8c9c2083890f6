"""The program's span log of the traced pass, for the readers of
``host_prep_ms``, ``host_issue_ms``, ``host_wait_ms``, ``h2d_gbps`` and
the split of the issue time (``issue_prep_ms``, ``issue_kernel_ms``,
``issue_finish_ms``) (not a metric: the harness reads only files whose
names do not start with ``_``).

The program logs a span only while a ``torch.profiler`` session records,
and the harness holds one only over its traced pass, which calls one
entry a request.  So the log's entry roots, the root spans that carry an
entry's counts (``records`` and ``h2d_bytes``), are that pass's requests
in order, one a request.  A root of any other kind (a host helper called
outside an entry) is no request and is passed over.  Where the log holds
another number of entry roots than the pass traced requests, or no log
at all (a program built before the spans), the readers give None.
"""

from __future__ import annotations


def requests(m):
    """``[(root, [descendants])]`` of the traced requests, in order, or
    None without a trace, without the program's span log, or where the log
    holds another number of entry roots than the pass traced requests."""
    if m.trace is None or not m.profiled:
        return None
    try:
        from ska_sdp_tpu_torch.utils.timing import spans
    except ImportError:
        return None
    log = spans()
    roots = [s for s in log if s.parent is None
             and "records" in s.counts and "h2d_bytes" in s.counts]
    if len(roots) != len(m.profiled):
        return None
    kids = {r.id: [] for r in roots}
    for s in log:
        if s.parent is not None and s.root in kids:
            kids[s.root].append(s)
    return [(r, kids[r.id]) for r in roots]


def seconds(s) -> float:
    return (s.end_ns - s.start_ns) / 1e9


def total_s(spans, name: str) -> float:
    """Seconds of the spans named ``name``, or whose names start with it
    where it ends in ``.``, each counted once: a span inside another such
    span is not counted again."""
    def hit(s):
        return (s.name.startswith(name) if name.endswith(".")
                else s.name == name)

    ids = {s.id: s for s in spans}
    total = 0.0
    for s in spans:
        if not hit(s):
            continue
        p = ids.get(s.parent)
        while p is not None and not hit(p):
            p = ids.get(p.parent)
        if p is None:
            total += seconds(s)
    return total


def mean_ms(m, per_request):
    """The mean over the traced requests of ``per_request(root, kids)``
    seconds, in milliseconds, or None without the span log."""
    reqs = requests(m)
    if reqs is None:
        return None
    return 1e3 * sum(per_request(r, k) for r, k in reqs) / len(reqs)
