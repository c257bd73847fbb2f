"""Background chunk prefetching — overlap host data prep with device compute.

The reference reads each chunk synchronously on the host, stalling the GPU
(Readchunk then train, BPtrain.cc:48-54).  Here one worker thread builds the
next chunk (NumPy or the native C++ pipeline) while the device trains the
current one; CUDA launches are asynchronous, so the handoff is hidden.  One
worker, so a producer that draws from the parity lrand48 stream consumes it
strictly in item order.  Own copy of tpu_sednn/data/prefetch.py.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Tuple, TypeVar

T = TypeVar("T")


class Prefetcher:
    """Iterate `producer(item)` results one step ahead of the consumer.

    Exceptions in the worker are re-raised at the consumption point.
    """

    def __init__(self, items: Iterable, producer: Callable[..., T], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._items = list(items)
        self._producer = producer
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for it in self._items:
                self._q.put(("ok", self._producer(it)))
            self._q.put(("done", None))
        except BaseException as e:  # surfaced to the consumer
            self._q.put(("err", e))

    def __iter__(self) -> Iterator[T]:
        while True:
            kind, payload = self._q.get()
            if kind == "ok":
                yield payload
            elif kind == "done":
                return
            else:
                raise payload

    def join(self, timeout: Optional[float] = 30.0) -> None:
        self._thread.join(timeout)


def prefetch_chunks(chunk_indices, read_fn, depth: int = 2) -> Iterator[Tuple]:
    """Convenience: yields read_fn(ci) for each chunk index, prefetched."""
    return iter(Prefetcher(chunk_indices, read_fn, depth))
