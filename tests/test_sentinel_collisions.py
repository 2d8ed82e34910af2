"""Regression tests: real keys that equal the padding sentinel must keep
their payloads (found by adversarial review — padding used to carry gidx=0
/ value=0 and could displace real max-key pairs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vkradixsort_tpu.engine.context import DeviceContext
from vkradixsort_tpu.parallel.distributed import gather_sorted, sort_sharded


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs a multi-device mesh")
def test_sort_sharded_kv_sentinel_keys(rng):
    """Distributed kv with keys at the encoded sentinel (INT32_MAX for i32):
    every payload must come back exactly."""
    mesh = DeviceContext().mesh_1d("x")
    P = mesh.shape["x"]
    n = P * P * 512
    keys = rng.integers(-1000, 1000, size=n).astype(np.int32)
    keys[:: n // 200] = np.iinfo(np.int32).max  # encodes to 0xFFFFFFFF
    vals = np.arange(1, n + 1, dtype=np.int32)
    pk, counts, overflow, pv = sort_sharded(
        jnp.asarray(keys), mesh, values=jnp.asarray(vals)
    )
    assert not np.any(np.asarray(overflow))
    got_k, got_v = gather_sorted(pk, counts, pv)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[perm])
    np.testing.assert_array_equal(got_v, vals[perm])


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs a multi-device mesh")
def test_sort_sharded_kv_u32_max_keys(rng):
    mesh = DeviceContext().mesh_1d("x")
    P = mesh.shape["x"]
    n = P * P * 256
    keys = rng.integers(0, 50, size=n, dtype=np.uint32)
    keys[::7] = np.uint32(0xFFFFFFFF)
    vals = np.arange(1, n + 1, dtype=np.int32)
    pk, counts, overflow, pv = sort_sharded(
        jnp.asarray(keys), mesh, values=jnp.asarray(vals)
    )
    assert not np.any(np.asarray(overflow))
    got_k, got_v = gather_sorted(pk, counts, pv)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[perm])
    np.testing.assert_array_equal(got_v, vals[perm])
