"""Tests for the flat and segmented XLA sort paths: segsort wrappers and the
tiled dispatcher."""

import jax.numpy as jnp
import numpy as np
import pytest

from vkradixsort_tpu.ops import common, segsort, tiled
from tests.conftest import make_keys


def test_signed_order_roundtrip(rng):
    k = jnp.asarray(make_keys(rng, 4096, np.uint32, "uniform"))
    s = segsort.to_signed_order(k)
    back = segsort.from_signed_order(s, jnp.uint32)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(k))
    order_u = np.argsort(np.asarray(k), kind="stable")
    order_s = np.argsort(np.asarray(s), kind="stable")
    np.testing.assert_array_equal(order_u, order_s)


@pytest.mark.parametrize("n", [1000, 100_000])
def test_sort_flat_u32(rng, n):
    k = make_keys(rng, n, np.uint32, "uniform")
    out, _ = segsort.sort_flat_u32(jnp.asarray(k))
    np.testing.assert_array_equal(np.asarray(out), np.sort(k))


def test_sort_flat_u64_kv(rng):
    k = make_keys(rng, 50_000, np.uint64, "uniform") % 997  # many ties
    v = jnp.arange(50_000, dtype=jnp.int32)
    out, (ov,) = segsort.sort_flat_u64(jnp.asarray(k), (v,))
    perm = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(np.asarray(out), k[perm])
    np.testing.assert_array_equal(np.asarray(ov), perm.astype(np.int32))


def test_sort_segments(rng):
    k = make_keys(rng, 8192, np.uint32, "uniform").reshape(4, 2048)
    out, _ = segsort.sort_segments(jnp.asarray(k))
    np.testing.assert_array_equal(np.asarray(out), np.sort(k, axis=1))


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_sort_tiled_dispatch(rng, dtype):
    k = make_keys(rng, 200_000, dtype, "zipf")
    enc = common.encode_keys(jnp.asarray(k))
    out, _ = tiled.sort_tiled(enc, ())
    np.testing.assert_array_equal(
        np.asarray(common.decode_keys(out, dtype)), np.sort(k)
    )
