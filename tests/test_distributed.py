"""Distributed sort tests on the 8-virtual-device CPU mesh (SURVEY.md §4 (c))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vkradixsort_tpu.engine.context import DeviceContext
from vkradixsort_tpu.parallel.distributed import (
    gather_sorted,
    sort_distributed,
    sort_sharded,
)
from tests.conftest import make_keys

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device mesh"
)


def _mesh():
    return DeviceContext().mesh_1d("x")


@pytest.mark.parametrize("n", [8 * 1024, 8 * 5000])
@pytest.mark.parametrize("dist", ["uniform", "uniform28", "descending", "constant"])
def test_sort_sharded_u32(rng, n, dist):
    keys = make_keys(rng, n, np.uint32, dist)
    mesh = _mesh()
    pk, counts, overflow = sort_sharded(jnp.asarray(keys), mesh)
    assert not np.any(np.asarray(overflow)), "bucket overflow at default slack"
    got = gather_sorted(pk, counts)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_sharded_zipf_skew(rng):
    # Heavy skew (BASELINE.json config #4): oversampling must keep buckets
    # within slack.
    keys = make_keys(rng, 8 * 4096, np.uint32, "zipf")
    mesh = _mesh()
    pk, counts, overflow = sort_sharded(
        jnp.asarray(keys), mesh, slack=4.0, oversample=64
    )
    assert not np.any(np.asarray(overflow))
    got = gather_sorted(pk, counts)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_sharded_kv_stability(rng):
    n = 8 * 2048
    keys = (make_keys(rng, n, np.uint32, "uniform") % 97).astype(np.uint32)
    vals = np.arange(n, dtype=np.int32)
    mesh = _mesh()
    pk, counts, overflow, pv = sort_sharded(
        jnp.asarray(keys), mesh, values=jnp.asarray(vals)
    )
    assert not np.any(np.asarray(overflow))
    got_k, got_v = gather_sorted(pk, counts, pv)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[perm])
    np.testing.assert_array_equal(got_v, perm.astype(np.int32))


def test_sort_sharded_u64(rng):
    keys = make_keys(rng, 8 * 1024, np.uint64, "uniform")
    mesh = _mesh()
    pk, counts, overflow = sort_sharded(jnp.asarray(keys), mesh)
    assert not np.any(np.asarray(overflow))
    got = gather_sorted(pk, counts)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_sharded_u64_zipf_kv(rng):
    # BASELINE.json config #4: 64-bit keys under heavy Zipf skew; the
    # composite splitters must keep buckets inside slack AND keep the kv
    # pairing stable.
    n = 8 * 2048
    keys = make_keys(rng, n, np.uint64, "zipf")
    vals = np.arange(n, dtype=np.int32)
    mesh = _mesh()
    pk, counts, overflow, pv = sort_sharded(
        jnp.asarray(keys), mesh, values=jnp.asarray(vals), slack=4.0, oversample=64
    )
    assert not np.any(np.asarray(overflow))
    got_k, got_v = gather_sorted(pk, counts, pv)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[perm])
    np.testing.assert_array_equal(got_v, perm.astype(np.int32))


def test_sort_sharded_float(rng):
    keys = ((rng.random(8 * 1024) * 2 - 1) * 1e6).astype(np.float32)
    mesh = _mesh()
    pk, counts, overflow = sort_sharded(jnp.asarray(keys), mesh)
    assert not np.any(np.asarray(overflow))
    got = gather_sorted(pk, counts)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_sharded_multi_payload(rng):
    n = 8 * 2048
    keys = (make_keys(rng, n, np.uint32, "uniform") % 211).astype(np.uint32)
    v1 = np.arange(n, dtype=np.int32)
    v2 = rng.standard_normal(n).astype(np.float32)
    mesh = _mesh()
    pk, counts, overflow, (p1, p2) = sort_sharded(
        jnp.asarray(keys), mesh, values=(jnp.asarray(v1), jnp.asarray(v2))
    )
    assert not np.any(np.asarray(overflow))
    got_k, (g1, g2) = gather_sorted(pk, counts, (p1, p2))
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[perm])
    np.testing.assert_array_equal(g1, perm.astype(np.int32))
    np.testing.assert_array_equal(g2, v2[perm])


def test_sort_sharded_descending_stable(rng):
    n = 8 * 2048
    keys = (make_keys(rng, n, np.uint32, "uniform") % 97).astype(np.uint32)
    vals = np.arange(n, dtype=np.int32)
    mesh = _mesh()
    pk, counts, overflow, pv = sort_sharded(
        jnp.asarray(keys), mesh, values=jnp.asarray(vals), descending=True
    )
    assert not np.any(np.asarray(overflow))
    got_k, got_v = gather_sorted(pk, counts, pv)
    perm = np.argsort(~keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[perm])
    np.testing.assert_array_equal(got_v, perm.astype(np.int32))


def test_sort_distributed_overflow_retry(rng):
    # slack=0.2 makes bucket capacity ~n_local/(5P): guaranteed overflow on
    # the first attempt; the wrapper must retry with doubled slack until the
    # exchange fits and still return the exact stable result.
    n = 8 * 2048
    keys = make_keys(rng, n, np.uint32, "uniform")
    mesh = _mesh()
    got = sort_distributed(jnp.asarray(keys), mesh, slack=0.2)
    np.testing.assert_array_equal(got, np.sort(keys))
    vals = np.arange(n, dtype=np.int32)
    got_k, got_v = sort_distributed(
        jnp.asarray(keys), mesh, values=jnp.asarray(vals), slack=0.2
    )
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[perm])
    np.testing.assert_array_equal(got_v, perm.astype(np.int32))


@pytest.mark.parametrize("dist", ["uniform", "descending", "constant", "zipf"])
def test_sort_sharded_overlapped(rng, dist):
    # overlap_chunks > 1: the software-pipelined body (chunk k sorts while
    # chunk k-1's all-to-all is in flight) must stay exact on every
    # distribution; the strided chunking keeps per-chunk buckets balanced
    # even for the adversarial descending input.
    n = 8 * 4096
    keys = make_keys(rng, n, np.uint32, dist)
    mesh = _mesh()
    pk, counts, overflow = sort_sharded(
        jnp.asarray(keys), mesh, overlap_chunks=4, slack=3.0
    )
    assert not np.any(np.asarray(overflow)), f"overflow ({dist})"
    got = gather_sorted(pk, counts)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_sharded_overlapped_kv_stable(rng):
    n = 8 * 2048
    keys = (make_keys(rng, n, np.uint32, "uniform") % 97).astype(np.uint32)
    vals = np.arange(n, dtype=np.int32)
    mesh = _mesh()
    pk, counts, overflow, pv = sort_sharded(
        jnp.asarray(keys), mesh, values=jnp.asarray(vals), overlap_chunks=4,
        slack=3.0,
    )
    assert not np.any(np.asarray(overflow))
    got_k, got_v = gather_sorted(pk, counts, pv)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[perm])
    np.testing.assert_array_equal(got_v, perm.astype(np.int32))


def test_sort_sharded_overlapped_periodic_adversary(rng):
    # Key pattern periodic in the chunk stride: even original positions get
    # high keys, odd get low. With overlap_chunks=2 and splitters sampled
    # from chunk 0 ONLY, chunk 1 (all-low keys) would dump entirely below
    # the first splitter and overflow at any practical slack; the mixed
    # chunk-0-quantiles + raw-other-chunk sampling must keep it in budget.
    n = 8 * 4096
    pos = np.arange(n, dtype=np.uint32)
    keys = np.where(pos % 2 == 0, np.uint32(0x80000000) + pos, pos).astype(np.uint32)
    mesh = _mesh()
    pk, counts, overflow = sort_sharded(
        jnp.asarray(keys), mesh, overlap_chunks=2, slack=3.0
    )
    assert not np.any(np.asarray(overflow)), "periodic adversary overflowed"
    got = gather_sorted(pk, counts)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_distributed_overlapped_retry(rng):
    n = 8 * 4096
    keys = make_keys(rng, n, np.uint32, "zipf")
    mesh = _mesh()
    got = sort_distributed(jnp.asarray(keys), mesh, slack=0.2, overlap_chunks=2)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_sharded_empty(rng):
    mesh = _mesh()
    keys = jnp.zeros((0,), jnp.uint32)
    pk, counts, overflow = sort_sharded(keys, mesh)
    assert pk.shape == (0,)
    assert np.asarray(counts).sum() == 0 and not np.any(np.asarray(overflow))
    pk, counts, overflow, pv = sort_sharded(
        keys, mesh, values=jnp.zeros((0,), jnp.int32)
    )
    assert pv.shape == (0,)
    assert gather_sorted(pk, counts).shape == (0,)


def test_sort_sharded_jit_compatible(rng):
    # The whole distributed sort inside a user jit.
    keys = make_keys(rng, 8 * 1024, np.uint32, "uniform")
    mesh = _mesh()

    @jax.jit
    def f(k):
        return sort_sharded(k, mesh)

    pk, counts, overflow = f(jnp.asarray(keys))
    got = gather_sorted(pk, counts)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_sharded_non_p2_multiple(rng):
    # only N % P is a caller obligation —
    # interleave/chunk grains pad internally. 8 * 997 is not a multiple of
    # P^2 = 64.
    n = 8 * 997
    keys = make_keys(rng, n, np.uint32, "uniform")
    vals = np.arange(n, dtype=np.int32)
    mesh = _mesh()
    pk, counts, overflow, pv = sort_sharded(
        jnp.asarray(keys), mesh, values=jnp.asarray(vals)
    )
    assert not np.any(np.asarray(overflow))
    got_k, got_v = gather_sorted(pk, counts, pv)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[perm])
    np.testing.assert_array_equal(got_v, perm.astype(np.int32))


def test_sort_sharded_overlapped_ragged_chunks(rng):
    # local size 997 is not a multiple of overlap_chunks=3 either
    n = 8 * 997
    keys = make_keys(rng, n, np.uint32, "uniform")
    mesh = _mesh()
    pk, counts, overflow = sort_sharded(
        jnp.asarray(keys), mesh, overlap_chunks=3, slack=3.0
    )
    assert not np.any(np.asarray(overflow))
    np.testing.assert_array_equal(gather_sorted(pk, counts), np.sort(keys))


def test_sort_sharded_sentinel_keys_non_p2(rng):
    # sentinel-valued real keys must not be confused with internal padding
    n = 8 * 500
    keys = make_keys(rng, n, np.uint32, "uniform")
    keys[:: 7] = np.uint32(0xFFFFFFFF)  # the encoded-key pad sentinel
    vals = np.arange(n, dtype=np.int32)
    mesh = _mesh()
    pk, counts, overflow, pv = sort_sharded(
        jnp.asarray(keys), mesh, values=jnp.asarray(vals), slack=3.0
    )
    assert not np.any(np.asarray(overflow))
    got_k, got_v = gather_sorted(pk, counts, pv)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[perm])
    np.testing.assert_array_equal(got_v, perm.astype(np.int32))


def test_sort_sharded_gidx_int64(rng):
    # the pod-scale position carry (N >= 2^31 auto-upgrades; opt in small)
    if not jax.config.jax_enable_x64:
        pytest.skip("needs x64")
    n = 8 * 1024
    keys = (make_keys(rng, n, np.uint32, "uniform") % 13).astype(np.uint32)
    vals = np.arange(n, dtype=np.int32)
    mesh = _mesh()
    pk, counts, overflow, pv = sort_sharded(
        jnp.asarray(keys), mesh, values=jnp.asarray(vals), gidx_dtype=jnp.int64
    )
    assert not np.any(np.asarray(overflow))
    got_k, got_v = gather_sorted(pk, counts, pv)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[perm])
    np.testing.assert_array_equal(got_v, perm.astype(np.int32))


@pytest.mark.parametrize("n", [8 * 1024, 1 << 24, 250_000_000, 1_250_000_000])
def test_quantile_positions_at_scale(n):
    # splitter samples must stay regular midpoints at device-scale shards:
    # i * n overflows int32 once n > 2^31 / m
    from vkradixsort_tpu.parallel.distributed import _quantile_positions

    m = 128
    pos = np.asarray(_quantile_positions(n, m))
    want = np.minimum(np.arange(m, dtype=np.int64) * n // m + n // (2 * m), n - 1)
    np.testing.assert_array_equal(pos, want)
    assert pos.dtype == np.int32 and np.all(np.diff(pos) > 0)
