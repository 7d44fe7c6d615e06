"""Double-buffered host-side prefetch.

The reference loads each frame synchronously on the VO thread
(cv::imread inside `getNextFrame`, reference src/LoopHandler.cc:917-927),
serializing disk IO with compute. Here a small thread pool decodes frames
ahead of the consumer so host IO overlaps device compute — the host side of
the "pipeline frame ingest against device compute" plan (SURVEY.md §5).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Sequence


class PrefetchIterator:
    """Iterator that decodes up to `depth` items ahead on a worker thread."""

    def __init__(self, items: Sequence, load_fn: Callable, depth: int = 2):
        self._items = list(items)
        self._load = load_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for it in self._items:
                if self._stop.is_set():
                    return
                self._q.put((True, self._load(it)))
        except Exception as e:  # surface loader errors on the consumer side
            self._q.put((False, e))
            return
        self._q.put((None, None))

    def __iter__(self):
        return self

    def __next__(self):
        ok, val = self._q.get()
        if ok is None:
            raise StopIteration
        if ok is False:
            raise val
        return val

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
