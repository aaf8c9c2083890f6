"""Structured metrics: a JSON-lines event log (port of
``ska_sdp_tpu/utils/metrics.py``).

One JSON object per event (``ts``, ``proc``, ``event`` and the caller's
fields), written with a single ``os.write`` on an ``O_APPEND`` descriptor,
so that processes writing to one local file never interleave partial
lines.  ``proc`` is ``torch.distributed.get_rank()`` when a process group
is initialised, else 0.

Enabled by a path, or by ``SKA_SDP_TPU_METRICS=<path>`` when none is
given (the CLI's ``--metrics``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MetricsSink:
    def __init__(self, path: Optional[str] = None):
        if path is None:
            path = os.environ.get("SKA_SDP_TPU_METRICS") or None
        self.path = path

    def emit(self, event: str, **fields: Any) -> None:
        if not self.path:
            return
        rec = {"ts": time.time(), "proc": _process_index(), "event": event,
               **fields}
        line = (json.dumps(rec) + "\n").encode()
        # atomic for small writes on a local POSIX file system; on NFS give
        # each process its own file and merge by "proc"
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, line)
        finally:
            os.close(fd)
