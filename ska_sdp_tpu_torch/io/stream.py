"""Background-prefetched slab streaming for out-of-core ingest (port of
``ska_sdp_tpu/io/stream.py``).

``SlabPrefetcher`` walks the visibility datasets in leading-axis slabs on
a host thread, keeping a bounded queue of slabs ahead of the consumer so
that reads overlap the gridding of the slab before.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Tuple


class SlabPrefetcher:
    """Iterate ``(start, {name: rows})`` slabs with background prefetch.

    ``readers`` maps a name to ``callable(start, count) -> ndarray``, so
    callers control the slicing (e.g. flattening a rank-3 vis block to the
    flat record order).  A reader's exception is raised on the consumer
    side; leaving the loop early, or :meth:`close`, releases the producer
    thread.  ``wait_s`` is the time the consumer spent waiting for a slab.
    """

    def __init__(self, readers: dict, total: int, slab: int,
                 start: int = 0, depth: int = 2):
        self.readers = readers
        self.total = total
        self.slab = slab
        self.start = start
        self.wait_s = 0.0
        self._stop = threading.Event()
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for s0 in range(self.start, self.total, self.slab):
                if self._stop.is_set():
                    return
                take = min(self.slab, self.total - s0)
                slabs = {n: rd(s0, take) for n, rd in self.readers.items()}
                if not self._put((s0, slabs)):
                    return
            self._put(None)
        except Exception as e:          # raised again on the consumer side
            self._put(e)

    def close(self) -> None:
        """Stop the producer, drop its queued slabs and wait up to 10 s
        for its thread to end (a read in progress finishes first)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not threading.current_thread():
            self._thread.join(10.0)

    def __iter__(self) -> Iterator[Tuple[int, dict]]:
        try:
            while True:
                t0 = time.perf_counter()
                item = self._q.get()
                self.wait_s += time.perf_counter() - t0
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            self.close()
