"""Timing + profiling harness for BASELINE metrics.

The reference's only notion of time is the matplotlib animation interval
(SURVEY.md section 5).  This module provides:
  * :func:`timed` - median wall time, each call fenced by
    ``jax.block_until_ready`` (dispatch is asynchronous, so an unfenced
    timing measures the enqueue);
  * :func:`steps_per_second` - throughput helper for the bench harness;
  * :func:`trace` - ``jax.profiler`` trace context for kernel-level
    inspection (view with TensorBoard / xprof).
"""

from __future__ import annotations

import contextlib
import time

import jax


def timed(fn, *args, reps: int = 5, warmup: int = 1):
    """Median wall-clock seconds of ``fn(*args)``, completion-fenced."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def steps_per_second(fn, *args, work_items: int, reps: int = 5):
    """work_items / median-time - the BASELINE throughput metric shape."""
    return work_items / timed(fn, *args, reps=reps)


@contextlib.contextmanager
def trace(log_dir: str):
    """``jax.profiler`` trace context (TensorBoard-viewable)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
