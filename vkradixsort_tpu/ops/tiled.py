"""Flat sort path — the multi_radixsort analog (SURVEY.md §7 L2/L3).

The reference's large-N regime tiles the array over many workgroups
coordinated through a global histogram table (reference
multiradixsort/resources/shaders/*.comp). Here XLA's native sort serves that
regime, driven in sign-flipped int space (ops/segsort.py): one direct sort
for keys-only (u32 and u64 alike), one carried sort for u32 key-value, and
two stable passes over 32-bit digits for 64-bit key-value sorts. On the GPU,
XLA lowers the one- and two-operand integer sorts to CUB's radix sort, which
is the reference's histogram / scan / rank-and-scatter pipeline.
"""

from __future__ import annotations

import jax.numpy as jnp

from vkradixsort_tpu.ops import segsort


def sort_tiled(enc: jnp.ndarray, vals: tuple):
    """Sort encoded (unsigned) keys + any number of payload planes.
    Returns ``(sorted_keys, sorted_vals_tuple)``."""
    if enc.dtype == jnp.uint32:
        return segsort.sort_flat_u32(enc, vals, stable=bool(vals))
    if enc.dtype == jnp.uint64:
        return segsort.sort_flat_u64(enc, vals, stable=bool(vals))
    raise TypeError(f"encoded keys must be uint32/uint64, got {enc.dtype}")
