"""Sort primitives built on XLA's native sort, in sign-flipped int space.

These wrappers put encoded (unsigned) keys into order-isomorphic
int32/int64 space and expose flat and segmented sorts. The signed mapping
dates from a backend whose sort was fast only on signed integers; it is
exact on every backend, and whether it costs anything on the GPU is an open
measurement. 64-bit keys-only sorts go through one direct i64 sort; 64-bit
key-value sorts use an LSD radix structure of two stable passes over 32-bit
digits (the reference's ITERATIONS 4<->8 dichotomy,
single_radixsort.comp:14, collapses to 1<->2 passes with 32-bit digits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_SIGN32 = np.uint32(0x80000000)
_SIGN64 = np.uint64(0x8000000000000000)


def to_signed_order(enc: jnp.ndarray) -> jnp.ndarray:
    """Map unsigned keys to same-width signed ints with identical order."""
    if enc.dtype == jnp.uint32:
        return (enc ^ _SIGN32).view(jnp.int32)
    if enc.dtype == jnp.uint64:
        return (enc ^ _SIGN64).view(jnp.int64)
    raise TypeError(enc.dtype)


def from_signed_order(s: jnp.ndarray, dtype) -> jnp.ndarray:
    if jnp.dtype(dtype) == jnp.uint32:
        return s.view(jnp.uint32) ^ _SIGN32
    if jnp.dtype(dtype) == jnp.uint64:
        return s.view(jnp.uint64) ^ _SIGN64
    raise TypeError(dtype)


def sort_flat(enc: jnp.ndarray, stable: bool = False) -> jnp.ndarray:
    """Keys-only flat sort of u32/u64-encoded keys via the signed fast path."""
    s = jax.lax.sort(to_signed_order(enc), dimension=0, is_stable=stable)
    return from_signed_order(s, enc.dtype)


def sort_flat_u32(enc: jnp.ndarray, values: tuple = (), stable: bool = False):
    """Flat sort of uint32-encoded keys (+ values) via XLA's signed fast path."""
    ops = jax.lax.sort(
        (to_signed_order(enc),) + tuple(values),
        dimension=0,
        is_stable=stable or bool(values),
        num_keys=1,
    )
    return from_signed_order(ops[0], jnp.uint32), tuple(ops[1:])


def sort_flat_u64(enc: jnp.ndarray, values: tuple = (), stable: bool = False):
    """uint64 keys: direct i64 sort when keys-only, else two chained stable
    32-bit-digit passes (LSD radix), each carrying narrower operands than
    one 64-bit-key carried sort would.
    """
    if not values:
        return sort_flat(enc, stable=stable), ()
    lo = (enc & np.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (enc >> np.uint64(32)).astype(jnp.uint32)
    # Pass 1: stable by low digit, carrying the high digit + payload.
    lo_s, rest = sort_flat_u32(lo, (hi,) + tuple(values), stable=True)
    # Pass 2: stable by high digit, carrying the reordered low digit + payload.
    hi_s, rest2 = sort_flat_u32(rest[0], (lo_s,) + tuple(rest[1:]), stable=True)
    out = (hi_s.astype(jnp.uint64) << np.uint64(32)) | rest2[0].astype(jnp.uint64)
    return out, tuple(rest2[1:])


def sort_segments(enc2d: jnp.ndarray, values2d: tuple = (), stable: bool = False):
    """Independent ascending sort of every row of a 2-D uint32/uint64
    array, as one batched XLA sort along the last axis; stable whenever
    payload planes ride along. Backs the public ``sort_segments``.
    """
    ops = jax.lax.sort(
        (to_signed_order(enc2d),) + tuple(values2d),
        dimension=1,
        is_stable=stable or bool(values2d),
        num_keys=1,
    )
    return from_signed_order(ops[0], enc2d.dtype), tuple(ops[1:])
