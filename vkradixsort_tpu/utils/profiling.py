"""Tracing / profiling helpers (SURVEY.md §5 "Tracing / profiling").

The reference's only instrumentation is wall-clock around
submit->vkQueueWaitIdle (reference SingleRadixSort.cpp:26-31) printed with a
component prefix (SingleRadixSort.h:40 PRINT_PREFIX). JAX equivalents:

  * ``trace(...)``: context manager around ``jax.profiler.trace`` producing
    a TensorBoard/Perfetto trace directory of the wrapped device work,
  * ``timed(...)``: the wall-clock analog with ``block_until_ready`` fencing
    (for throwaway measurements; use utils/timing.py for real numbers),
  * ``log(...)``: component-prefixed stderr logging like the reference's
    ``[MultiRadixSort] ...`` lines,
  * ``hbm_traffic_estimate(...)``: bytes-touched lower bound for a sort
    call, for roofline sanity checks against measured time.
"""

from __future__ import annotations

import contextlib
import sys
import time

import jax


def log(component: str, *message) -> None:
    """``[Component] message`` to stderr (reference PRINT_PREFIX style)."""
    print(f"[{component}]", *message, file=sys.stderr, flush=True)


@contextlib.contextmanager
def trace(logdir: str = "/tmp/vkrs_trace"):
    """Capture a device profile of the enclosed block.

    View with TensorBoard's profile plugin or Perfetto. Wraps
    ``jax.profiler.trace``; remember to ``block_until_ready`` inside the
    block or the trace ends before the device work does.
    """
    with jax.profiler.trace(logdir):
        yield logdir
    log("profiler", f"trace written to {logdir}")


@contextlib.contextmanager
def timed(label: str, component: str = "vkradixsort"):
    """Wall-clock a block with a completion fence — the reference's
    steady_clock-around-waitIdle pattern. Yields a dict that receives
    ``seconds`` on exit.

    Store the block's device outputs in the yielded dict (any key) and the
    fence blocks on them; otherwise a trailing no-op computation is
    enqueued and blocked on — the device executes per-stream in launch
    order, so it completes only after the block's dispatched work.
    """
    import jax.numpy as jnp

    out = {}
    t0 = time.perf_counter()
    yield out
    arrays = [v for v in out.values() if isinstance(v, jax.Array)]
    jax.block_until_ready(arrays if arrays else jnp.zeros(()) + 0.0)
    out["seconds"] = time.perf_counter() - t0
    log(component, f"{label} finished in {out['seconds'] * 1e3:.3f} ms")


def block(tree):
    """block_until_ready over an arbitrary pytree; returns the tree."""
    return jax.block_until_ready(tree)


def hbm_traffic_estimate(n: int, itemsize: int, *, passes: int = 1,
                         kv: bool = False) -> int:
    """Lower-bound HBM bytes for ``passes`` read+write sweeps over the data.

    For roofline checks: measured_time >= estimate / HBM_BW (an H100 SXM's
    published device-memory bandwidth is 3.35 TB/s).
    """
    width = itemsize * (2 if kv else 1)
    return 2 * passes * n * width
