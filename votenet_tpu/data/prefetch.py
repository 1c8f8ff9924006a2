"""Background prefetching for the input pipeline.

The reference overlaps host data work with training via
``PrefetchDataZMQ(train_set, nproc)`` fork-workers + a TF ``QueueInput``
staging queue (run.py:121-122). The JAX equivalent: a thread/process pool
producing batches into a bounded queue while the accelerator steps — JAX's
async dispatch plays the role of the staging queue.

- :class:`PrefetchIterator` — single background thread, bounded buffer.
- :class:`ParallelSceneLoader` — process pool mapping scene ids through
  ``process_scene`` (CPU-bound numpy work: subsample, project, augment),
  the fork-worker analogue.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

_SENTINEL = object()


class PrefetchIterator:
    """Wrap an iterable; produce items from a background thread.

    ``buffer_size`` bounds host memory (like the ZMQ pipe's HWM).
    """

    def __init__(self, iterable: Iterable, buffer_size: int = 4):
        self._iterable = iterable
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._iterable:
                self._q.put(item)
        except BaseException as e:  # propagate to consumer
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(iterable: Iterable, buffer_size: int = 4) -> PrefetchIterator:
    return PrefetchIterator(iterable, buffer_size)


class ParallelSceneLoader:
    """Process-pool scene loading (the PrefetchDataZMQ fork-worker analogue).

    Maps ``fn`` (e.g. a process_scene closure) over ids with
    ``num_workers`` processes, yielding results in completion order (the
    reference's ZMQ pipe is also unordered). Falls back to serial when
    ``num_workers <= 1``. ``run_train`` does not use it.

    The workers are forked: create the loader before JAX has opened a GPU
    in this process, because a forked child must not inherit a live device
    context (it neither can use it nor release it cleanly).
    """

    def __init__(self, fn: Callable, ids, num_workers: int = 0):
        self.fn = fn
        self.ids = list(ids)
        self.num_workers = num_workers

    def __iter__(self):
        if self.num_workers <= 1:
            for i in self.ids:
                out = self.fn(i)
                if out is not None:
                    yield out
            return
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        with ctx.Pool(self.num_workers) as pool:
            for out in pool.imap_unordered(self.fn, self.ids, chunksize=4):
                if out is not None:
                    yield out
