"""Unit tests for key encodings and digit extraction."""

import jax.numpy as jnp
import numpy as np
import pytest

from vkradixsort_tpu.ops import common
from tests.conftest import make_keys


@pytest.mark.parametrize(
    "dtype,dist",
    [
        (np.uint32, "uniform"),
        (np.uint64, "uniform"),
        (np.int32, "uniform"),
        (np.int64, "uniform"),
        (np.float32, "uniform"),
        (np.float64, "uniform"),
    ],
)
def test_encode_order_preserving(rng, dtype, dist):
    keys = make_keys(rng, 4096, dtype, dist)
    if np.dtype(dtype).kind == "f":
        keys[:16] = [0.0, -0.0, np.inf, -np.inf, 1.5, -1.5, 1e-38, -1e-38] * 2
    enc = np.asarray(common.encode_keys(jnp.asarray(keys)))
    order_orig = np.argsort(keys, kind="stable")
    order_enc = np.argsort(enc, kind="stable")
    np.testing.assert_array_equal(keys[order_orig], keys[order_enc])


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64, np.int32, np.int64, np.float32, np.float64])
def test_encode_decode_roundtrip(rng, dtype):
    keys = make_keys(rng, 2048, dtype, "uniform")
    enc = common.encode_keys(jnp.asarray(keys))
    dec = np.asarray(common.decode_keys(enc, dtype))
    np.testing.assert_array_equal(dec, keys)


def test_extract_digit_matches_shift_mask(rng):
    keys = jnp.asarray(make_keys(rng, 1024, np.uint32, "uniform"))
    for shift in (0, 8, 16, 24):
        got = np.asarray(common.extract_digit(keys, shift))
        want = (np.asarray(keys) >> shift) & 0xFF
        np.testing.assert_array_equal(got, want.astype(np.int32))


def test_num_passes():
    assert common.num_passes(jnp.uint32) == 4
    assert common.num_passes(jnp.uint64) == 8


def test_pad_to_sentinels():
    k = jnp.asarray([3, 1, 2], dtype=jnp.uint32)
    p = common.pad_to(k, 8)
    assert p.shape == (8,)
    assert np.all(np.asarray(p[3:]) == np.iinfo(np.uint32).max)
