"""Profiling/observability helpers (utils/profiling.py)."""

import jax.numpy as jnp
import numpy as np

from vkradixsort_tpu.utils import profiling


def test_timed_and_block(capsys):
    with profiling.timed("noop", component="Test") as out:
        profiling.block(jnp.arange(8) * 2)
    assert out["seconds"] >= 0
    err = capsys.readouterr().err
    assert "[Test] noop finished in" in err


def test_log_prefix(capsys):
    profiling.log("MultiRadixSort", "GPU sort finished in", 1.23, "[ms].")
    assert capsys.readouterr().err.startswith("[MultiRadixSort]")


def test_hbm_traffic_estimate():
    # 4 radix passes over 1e8 u32 kv pairs: 2 * 4 * 1e8 * 8 bytes
    assert profiling.hbm_traffic_estimate(10**8, 4, passes=4, kv=True) == 64 * 10**8
    assert profiling.hbm_traffic_estimate(10, 4) == 80


def test_trace_writes_dir(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        profiling.block(jnp.cumsum(jnp.ones(1024)))
    import os

    assert os.path.isdir(d)


def test_median_seconds_fences_and_warms_up():
    from vkradixsort_tpu.utils.timing import median_seconds

    calls = []

    def f(x):
        calls.append(1)
        return x * 2

    t = median_seconds(f, jnp.arange(8), reps=3)
    assert t >= 0 and len(calls) == 4  # one warm-up + three timed calls
