"""Host-side batch prefetcher (the port's copy of lvv_tpu/data/prefetch.py).

While the card runs step N the host is free, but only if the next batch is
already collated and on its way to the card. `Prefetcher` runs the
(CPU-bound) sample / collate / copy work on a background thread a fixed
`depth` ahead of the consumer, so host data prep overlaps device compute
instead of serializing with it. The trainer's `prepare` copies each batch
to the card with `non_blocking=True`.

Exceptions raised by the source iterator or the `prepare` fn are re-raised
at the consuming `next()` call, preserving the synchronous contract.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

_DONE = object()


class Prefetcher:
    """Iterate `src`, applying `prepare` on a worker thread, `depth` ahead.

    prepare : e.g. `lambda b: b.to(device, non_blocking=True)` — runs on the
        worker so the copy is already in flight when the consumer arrives.
    depth : bounded lookahead (bounds host memory at depth live batches).
    """

    def __init__(self, src: Iterable, prepare: Optional[Callable] = None,
                 depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._src = iter(src)
        self._prepare = prepare
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work,
                                        name="lvv-prefetch", daemon=True)
        self._thread.start()

    def _work(self) -> None:
        try:
            for item in self._src:
                if self._prepare is not None:
                    item = self._prepare(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(_DONE)
        except BaseException as e:  # surfaced at the consumer's next()
            self._q.put(e)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _DONE:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def close(self) -> None:
        """Stop the worker; safe to call mid-iteration (early break)."""
        self._stop.set()
        # unblock a worker stuck on put()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
