"""Device timing: wall clock around work that ends in ``block_until_ready``.

The reference times GPU work as wall-clock around submit->vkQueueWaitIdle
(reference singleradixsort/src/SingleRadixSort.cpp:26-31). JAX dispatch is
asynchronous, so the fence here is ``jax.block_until_ready`` on the outputs;
a timing without it measures the enqueue.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import jax


def median_seconds(fn: Callable, *args, reps: int = 5) -> float:
    """Median wall seconds of ``fn(*args)`` over ``reps`` fenced calls,
    after one untimed warm-up call (which pays any compilation)."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)
