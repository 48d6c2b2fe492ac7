# Port copy of clairs_to_tpu/parallel/scheduler.py (owned_chunks and PrefetchPipeline only).
"""Chunk scheduling on the host.

Decode-ahead for the calling loop: chunk N+1 is decoded on worker threads
while chunk N's batches run on the device.  ``owned_chunks`` is the static
round-robin split across hosts; multi-host runs themselves are not part of
the port yet.
"""

import threading
from typing import Callable, Iterable, List


def owned_chunks(chunks: List, process_index: int, process_count: int) -> List:
    """Round-robin chunk ownership across hosts (static, deterministic —
    matching the reference's CHUNK_LIST static split, run_clairs_to:553-561)."""
    return [c for i, c in enumerate(chunks) if i % process_count == process_index]


class PrefetchPipeline:
    """Decode-ahead pipeline: host workers prepare chunk work items while the
    consumer (device loop) drains them in order."""

    def __init__(self, produce: Callable, items: Iterable, depth: int = 2,
                 workers: int = 2):
        self._produce = produce
        self._items = list(items)
        self._results = {}
        self._cv = threading.Condition()
        self._next_to_emit = 0
        self._next_to_take = 0
        self._depth = depth
        self._threads = [
            threading.Thread(target=self._worker, daemon=True) for _ in range(workers)
        ]
        self._errors = []
        for t in self._threads:
            t.start()

    def _worker(self):
        while True:
            with self._cv:
                while (
                    self._next_to_take < len(self._items)
                    and self._next_to_take - self._next_to_emit >= self._depth
                ):
                    self._cv.wait()
                if self._next_to_take >= len(self._items):
                    return
                idx = self._next_to_take
                self._next_to_take += 1
            try:
                res = self._produce(self._items[idx])
            except Exception as e:  # propagate to the consumer
                res = None
                with self._cv:
                    self._errors.append((idx, e))
                    self._cv.notify_all()
                continue
            with self._cv:
                self._results[idx] = res
                self._cv.notify_all()

    def __iter__(self):
        for idx in range(len(self._items)):
            with self._cv:
                while idx not in self._results and not any(
                    i == idx for i, _ in self._errors
                ):
                    self._cv.wait()
                for i, e in self._errors:
                    if i == idx:
                        raise e
                res = self._results.pop(idx)
                self._next_to_emit = idx + 1
                self._cv.notify_all()
            yield self._items[idx], res
