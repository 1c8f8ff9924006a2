"""Profiling / tracing utilities.

The reference has no profiler integration — only manual wall-clock loops in
op ``__main__`` blocks (SURVEY §5). Here: a context manager around
``jax.profiler`` traces, a device timer that waits with
``jax.block_until_ready``, and annotation helpers.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import jax


def device_timeit(fn, iters: int = 10, warmup: int = 2) -> float:
    """Average seconds per call; dispatches async, waits once at the end."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """jax.profiler trace context; view with tensorboard/xprof."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


annotate = jax.profiler.TraceAnnotation
