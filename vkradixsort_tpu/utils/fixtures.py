"""Key-distribution fixtures shared by tests and benchmarks.

Mirrors the reference's generators plus the north-star extensions:
uniform 28-bit (reference SingleRadixSort.cpp:85-98 caps at 0x0FFFFFFF),
full-width uniform, descending (the commented-out alternate fixture,
SingleRadixSort.cpp:96), constant, and Zipf-skewed (BASELINE.json #4).
"""

from __future__ import annotations

import numpy as np


def make_keys(rng, n, dtype=np.uint32, distribution="uniform28"):
    dtype = np.dtype(dtype)
    if dtype.kind == "V":
        # ml_dtypes' bfloat16: draw as float32, then round to the narrow type
        return make_keys(rng, n, np.float32, distribution).astype(dtype)
    if distribution == "uniform28":
        hi = min(1 << 28, int(np.iinfo(dtype).max)) if dtype.kind == "u" else 1 << 28
        return rng.integers(
            0, hi, size=n, dtype=dtype if dtype.kind == "u" else np.uint64
        ).astype(dtype)
    if distribution == "uniform":
        if dtype.kind in "ui":
            info = np.iinfo(dtype)
            # endpoint=True: dtype max IS reachable, so fixture-driven tests
            # can hit the sentinel-collision class (keys == pad_sentinel)
            return rng.integers(info.min, int(info.max), size=n, dtype=dtype,
                                endpoint=True)
        return (rng.random(n) * 2 - 1).astype(dtype) * 1e6
    if distribution == "descending":
        if dtype.kind == "f":
            return np.arange(n, 0, -1).astype(dtype)
        # go through uint64: iinfo(uint64).max does not fit the int64 arange
        arr = np.arange(n, 0, -1).astype(np.uint64)
        return (arr % np.uint64(np.iinfo(dtype).max)).astype(dtype)
    if distribution == "constant":
        return np.full(n, 42, dtype=dtype)
    if distribution == "zipf":
        raw = rng.zipf(1.3, size=n).astype(np.uint64)
        mod = np.uint64(np.iinfo(dtype).max) if dtype.kind == "u" else np.uint64(1 << 30)
        return (raw % mod).astype(dtype)
    raise ValueError(distribution)
