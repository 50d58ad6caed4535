"""Input prefetch: overlap host batch assembly with device compute
(counterpart of :mod:`apex_tpu.io.prefetch`).

The role torch DataLoader workers play for the reference's examples: a
background thread assembles batches (with the native ``gather_rows``,
and for a CUDA run into pinned memory) and keeps a bounded queue ahead
of the training loop, whose asynchronous host-to-device copy then
overlaps the previous step's compute.
"""

import queue
import threading
from typing import Callable, Iterator, Optional


class PrefetchIterator:
    """Wrap any iterator with a depth-``size`` background prefetch queue."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, size: int = 2, transform: Optional[Callable] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=size)
        self._transform = transform
        self._err = None

        def worker():
            try:
                for item in it:
                    self._q.put(self._transform(item) if self._transform else item)
            except BaseException as e:  # surface errors on the consumer side
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
