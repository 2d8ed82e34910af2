"""Oracle tests: the pure-jnp radix sort vs numpy, phase by phase.

Mirrors the reference's verification strategy (exact element-wise match vs
std::sort, SingleRadixSort.cpp:113-126) and extends it per SURVEY.md §4:
per-phase unit tests, stability via payload checks, many distributions/sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from vkradixsort_tpu.ops import common, reference
from tests.conftest import make_keys


def test_chunk_histograms_vs_bincount(rng):
    keys = jnp.asarray(make_keys(rng, 8192, np.uint32, "uniform"))
    for shift in (0, 16):
        hist = np.asarray(reference.chunk_histograms(keys, shift, num_chunks=8))
        digits = (np.asarray(keys) >> shift) & 0xFF
        for c in range(8):
            want = np.bincount(digits.reshape(8, -1)[c], minlength=256)
            np.testing.assert_array_equal(hist[c], want)


def test_exclusive_bin_offsets(rng):
    hist = jnp.asarray(rng.integers(0, 50, size=(4, 256), dtype=np.int32))
    off = np.asarray(reference.exclusive_bin_offsets(hist))
    h = np.asarray(hist)
    want = np.zeros_like(h)
    running = 0
    for b in range(256):
        for c in range(4):
            want[c, b] = running
            running += h[c, b]
    np.testing.assert_array_equal(off, want)


def test_rank_in_chunk_stability(rng):
    digits = jnp.asarray(rng.integers(0, 256, size=(2, 512), dtype=np.int32))
    rank = np.asarray(reference.rank_in_chunk(digits))
    d = np.asarray(digits)
    for c in range(2):
        seen = {}
        for i in range(512):
            expect = seen.get(d[c, i], 0)
            assert rank[c, i] == expect
            seen[d[c, i]] = expect + 1


@pytest.mark.parametrize("n", [1, 2, 100, 1000, 10_000])
@pytest.mark.parametrize("dist", ["uniform28", "uniform", "descending", "constant", "zipf"])
def test_sort_u32_matches_numpy(rng, n, dist):
    keys = make_keys(rng, n, np.uint32, dist)
    got = np.asarray(reference.radix_sort_reference(jnp.asarray(keys)))
    np.testing.assert_array_equal(got, np.sort(keys, kind="stable"))


@pytest.mark.parametrize("dtype", [np.uint64, np.int32, np.int64, np.float32, np.float64])
def test_sort_other_dtypes(rng, dtype):
    keys = make_keys(rng, 4096, dtype, "uniform")
    got = np.asarray(reference.radix_sort_reference(jnp.asarray(keys)))
    np.testing.assert_array_equal(got, np.sort(keys, kind="stable"))


@pytest.mark.parametrize("num_chunks", [1, 4, 16])
def test_sort_chunked_equivalence(rng, num_chunks):
    keys = make_keys(rng, 4096, np.uint32, "uniform")
    got = np.asarray(
        reference.radix_sort_reference(jnp.asarray(keys), num_chunks=num_chunks)
    )
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_pairs_stability(rng):
    # Few distinct keys -> many ties; payload order must match np stable argsort.
    keys = make_keys(rng, 5000, np.uint32, "uniform") % 37
    vals = jnp.arange(5000, dtype=jnp.uint32)
    k, v = reference.radix_sort_reference(jnp.asarray(keys), vals)
    want_perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(v), want_perm.astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(k), keys[want_perm])


def test_argsort_reference(rng):
    keys = make_keys(rng, 3000, np.uint32, "zipf")
    got = np.asarray(reference.argsort_reference(jnp.asarray(keys)))
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable").astype(np.uint32))
