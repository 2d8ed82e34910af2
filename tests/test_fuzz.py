"""Seeded fuzz: random (size, dtype, distribution, op) cases vs the numpy
oracle through the PUBLIC API only.

The reference tests one hard-coded configuration per binary (SURVEY.md §4);
the structured suites here test each feature on fixed shapes. This file
closes the gap between those: deterministic pseudo-random sampling of the
whole input space, so dtype/size/edge interactions the structured tests
never combine (e.g. int16 descending kv at a prime size) still get hit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vkradixsort_tpu as vk
from tests.conftest import make_keys

CASES = 24


def _random_case(rng):
    n = int(rng.integers(0, 50_000))
    dtype = rng.choice(
        [np.uint32, np.int32, np.float32, np.uint16, np.int16, np.uint64, np.int64]
    )
    dist = rng.choice(["uniform", "uniform28", "descending", "constant", "zipf"])
    return n, np.dtype(dtype), dist


def _keys(rng, n, dtype, dist):
    if dtype.kind == "f":
        k = (rng.random(n) * 2 - 1).astype(dtype) * 1e6
        k[rng.integers(0, 2, size=n).astype(bool)] = dtype.type(0.5)  # ties
        return k
    return make_keys(rng, n, dtype, dist)


@pytest.mark.parametrize("case", range(CASES))
def test_fuzz_sort_and_pairs(case):
    rng = np.random.default_rng(0xF0 + case)
    n, dtype, dist = _random_case(rng)
    if dtype.kind == "f":
        dist = "uniform"
    k = _keys(rng, n, dtype, dist)

    got = np.asarray(vk.sort(jnp.asarray(k)))
    np.testing.assert_array_equal(got, np.sort(k), err_msg=f"{n} {dtype} {dist}")

    v = np.arange(n, dtype=np.uint32)
    ok, ov = vk.sort_pairs(jnp.asarray(k), jnp.asarray(v))
    perm = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(np.asarray(ok), k[perm], err_msg=f"{n} {dtype} {dist}")
    np.testing.assert_array_equal(
        np.asarray(ov), perm.astype(np.uint32), err_msg=f"{n} {dtype} {dist}"
    )

    agot = np.asarray(vk.argsort(jnp.asarray(k), descending=True))
    if dtype.kind == "u":
        dperm = np.argsort(~k, kind="stable")
    else:
        # descending stable = ascending stable on the order-reversed key;
        # realize it via lexsort on (-rank, position)
        asc = np.argsort(k, kind="stable")
        ranks = np.empty(n, dtype=np.int64)
        ranks[asc] = np.arange(n)
        # equal keys share ascending order; stable descending keeps original
        # input order among ties, so sort by (key descending, position)
        keyrank = np.empty(n, dtype=np.int64)
        sk = k[asc]
        # group ranks: same key -> same group id
        if n:
            grp = np.concatenate([[0], np.cumsum(sk[1:] != sk[:-1])])
            keyrank[asc] = grp
            dperm = np.lexsort((np.arange(n), -keyrank))
        else:
            dperm = np.arange(0)
    np.testing.assert_array_equal(agot, dperm.astype(np.uint32), err_msg=f"{n} {dtype} {dist}")
