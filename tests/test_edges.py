"""Degenerate-size edges: both paths must pass N=0/1/2 through exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

import vkradixsort_tpu as vk


@pytest.mark.parametrize("n", [0, 1, 2])
@pytest.mark.parametrize("engine", ["reference", "tiled"])
def test_tiny_n(n, engine):
    k = jnp.asarray(np.arange(n, dtype=np.uint32)[::-1].copy())
    out = np.asarray(vk.sort(k, backend=engine))
    np.testing.assert_array_equal(out, np.sort(np.asarray(k)))


def test_tiny_n_pairs():
    for n in [0, 1, 2]:
        k = jnp.asarray(np.zeros(n, np.uint32))
        v = jnp.asarray(np.arange(n, dtype=np.int32))
        ok, ov = vk.sort_pairs(k, v)
        assert ok.shape == (n,) and ov.shape == (n,)
        np.testing.assert_array_equal(np.asarray(ov), np.arange(n, dtype=np.int32))
