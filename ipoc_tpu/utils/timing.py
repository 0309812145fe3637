"""Benchmark timing protocol (reference pendulum_runtime.py:104-139).

One untimed warmup call to exclude compilation, then N timed repetitions
with ``jax.block_until_ready``; mean and median reported.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import jax


def time_fn(fn: Callable, *args, reps: int = 10, warmup: int = 1):
    """Run the reference timing protocol on ``fn(*args)``.

    Returns ``(mean_s, median_s, times)``.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.fmean(times), statistics.median(times), times
