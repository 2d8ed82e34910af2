"""The public API over its whole input grid, checked against numpy's stable
order: every entry point x every supported key dtype x the five
``make_keys`` distributions x both directions."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

import vkradixsort_tpu as vk
from tests.conftest import make_keys

N = 300
ROWS, WIDTH = 4, 75

DTYPES = [
    np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
    np.uint64, np.int64, np.float16, ml_dtypes.bfloat16, np.float32, np.float64,
]
DISTRIBUTIONS = ["uniform28", "uniform", "descending", "constant", "zipf"]


def _stable_perm(k, descending, axis=-1):
    """numpy's stable order; descending keeps ties in input order."""
    # floats widen exactly to float64, which numpy orders for every width
    exact = k.astype(np.float64) if k.dtype.kind in "fV" else k
    ranks = np.unique(exact, return_inverse=True)[1].reshape(k.shape)
    return np.argsort(-ranks if descending else ranks, axis=axis, kind="stable")


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _keys(dtype, dist):
    rng = np.random.default_rng(0xA11 + DISTRIBUTIONS.index(dist))
    return make_keys(rng, N, np.dtype(dtype), dist)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dist", DISTRIBUTIONS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize(
    "op", ["sort", "sort_pairs", "sort_pairs_unstable", "argsort", "sort_segments"]
)
def test_public_api_grid(op, dtype, dist, descending):
    k = _keys(dtype, dist)
    if op == "sort_segments":
        k = k[: ROWS * WIDTH].reshape(ROWS, WIDTH)
        col = np.broadcast_to(np.arange(WIDTH, dtype=np.uint32), k.shape)
        perm = _stable_perm(k, descending)
        ok, oc = vk.sort_segments(jnp.asarray(k), jnp.asarray(col), descending=descending)
        np.testing.assert_array_equal(_bits(ok), _bits(np.take_along_axis(k, perm, 1)))
        np.testing.assert_array_equal(np.asarray(oc), perm.astype(np.uint32))
        return
    perm = _stable_perm(k, descending)
    pos = np.arange(N, dtype=np.uint32)
    if op == "sort":
        out = vk.sort(jnp.asarray(k), descending=descending)
        np.testing.assert_array_equal(_bits(out), _bits(k[perm]))
    elif op == "argsort":
        out = vk.argsort(jnp.asarray(k), descending=descending)
        np.testing.assert_array_equal(np.asarray(out), perm.astype(np.uint32))
    else:
        stable = op == "sort_pairs"
        ok, ov = vk.sort_pairs(
            jnp.asarray(k), jnp.asarray(pos), descending=descending, stable=stable
        )
        ok, ov = np.asarray(ok), np.asarray(ov)
        np.testing.assert_array_equal(_bits(ok), _bits(k[perm]))
        if stable:
            np.testing.assert_array_equal(ov, perm.astype(np.uint32))
        else:
            # any tie order: the payloads must be a permutation that still
            # pairs with the keys
            np.testing.assert_array_equal(np.sort(ov), pos)
            np.testing.assert_array_equal(_bits(k[ov]), _bits(ok))
