"""Key-width configurations: 8- and 16-bit keys through the public API.

The reference's key width is a compile-time config (SORT_32BIT /
SORT_64_BIT, SingleRadixSort.h:10-18); here every width is a dtype the
public entry points accept, widened to the 32-bit sort domain.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import vkradixsort_tpu as vk


# --- structured 8/16-bit key coverage ---------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.uint16, np.int16])
def test_small_int_keys_sort(rng, dtype):
    n = 20_000
    info = np.iinfo(dtype)
    k = rng.integers(info.min, int(info.max) + 1, size=n, dtype=dtype)
    out = np.asarray(vk.sort(jnp.asarray(k)))
    np.testing.assert_array_equal(out, np.sort(k))
    out_d = np.asarray(vk.sort(jnp.asarray(k), descending=True))
    np.testing.assert_array_equal(out_d, np.sort(k)[::-1])


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
def test_small_int_keys_stable_pairs(rng, dtype):
    # tiny key space = massive ties: the strongest stability probe
    n = 30_000
    info = np.iinfo(dtype)
    k = rng.integers(info.min, int(info.max) + 1, size=n, dtype=dtype)
    v = np.arange(n, dtype=np.uint32)
    ok, ov = vk.sort_pairs(jnp.asarray(k), jnp.asarray(v))
    perm = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(np.asarray(ok), k[perm])
    np.testing.assert_array_equal(np.asarray(ov), perm.astype(np.uint32))


@pytest.mark.parametrize("dtype", [np.uint16, np.int8])
def test_small_int_argsort(rng, dtype):
    n = 10_000
    info = np.iinfo(dtype)
    k = rng.integers(info.min, int(info.max) + 1, size=n, dtype=dtype)
    perm = np.asarray(vk.argsort(jnp.asarray(k)))
    np.testing.assert_array_equal(perm, np.argsort(k, kind="stable"))
