"""Public sort API (SURVEY.md §7 L3).

The reference ships two separate hard-wired programs and documents "use
single for N < ~10k, multi otherwise" (reference README.md:11-22). Here one
public ``sort`` / ``sort_pairs`` / ``argsort`` / ``sort_segments`` serves
every size through one path:

  engine        analog of                      use
  ------------  -----------------------------  --------------------------------
  "tiled"       multi_radixsort (production)   XLA's ``lax.sort`` in signed
                                               space (ops/tiled.py ->
                                               ops/segsort.py); the default
                                               for every call on every
                                               platform
  "reference"   the CPU std::sort oracle       pure-jnp LSD radix sort; a test
                                               oracle, reached only through an
                                               explicit ``backend="reference"``

On the GPU, XLA hands one- and two-operand integer sorts to CUB's radix sort
(the reference's per-workgroup histogram / global scan / rank-and-scatter
design, SURVEY.md §2-3) and sorts the rest with its own sort kernel. The
small-N "single" regime needs no engine of its own: XLA already sorts a small
array in one kernel.

All entry points are jit-compatible, stable, and bitwise-exact vs np.sort.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from vkradixsort_tpu.ops import reference, segsort, tiled
from vkradixsort_tpu.ops.common import decode_keys, encode_keys, sortable_dtype

ENGINES = ("tiled", "reference")


def _route(backend: str | None) -> str:
    """The sort path: ``"tiled"`` unless the caller names the oracle."""
    if backend is None:
        return "tiled"
    if backend not in ENGINES:
        raise ValueError(f"unknown backend {backend!r}; pick from {ENGINES}")
    return backend


def _sort_encoded(enc, vals: tuple, path: str):
    """Sort already-encoded unsigned keys via the selected path.

    ``vals`` is a tuple of payload arrays riding along with the keys (empty
    for keys-only). Returns ``(sorted_keys, sorted_vals_tuple)``.
    """
    if path == "tiled":
        return tiled.sort_tiled(enc, vals)
    if len(vals) <= 1:
        out_k, out_v = reference._sort_encoded(
            enc, vals[0] if vals else None, num_chunks=1
        )
        return out_k, (out_v,) if vals else ()
    # Multi-payload on the jnp oracle: one sort carrying the positions,
    # then gather every payload.
    idx = jnp.arange(enc.shape[0], dtype=jnp.int32)
    out_k, perm = reference._sort_encoded(enc, idx, num_chunks=1)
    return out_k, tuple(jnp.take(v, perm) for v in vals)


def _encode(keys, descending: bool):
    enc = encode_keys(keys)
    return ~enc if descending else enc


def _decode(out, dtype, descending: bool):
    return decode_keys(~out if descending else out, dtype)


def sort(
    keys: jnp.ndarray,
    *,
    backend: str | None = None,
    descending: bool = False,
) -> jnp.ndarray:
    """Stable ascending (or descending) sort of a 1-D key array.

    Analog of running the reference's whole SingleRadixSort/MultiRadixSort
    drivers (SingleRadixSort.h:21, MultiRadixSort.h:21), as a function.

    Float keys sort by IEEE-754 **total order** (the standard radix-sort
    convention): ``-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN``.
    This is value-equal to ``np.sort`` except that ``-0.0`` orders strictly
    before ``+0.0`` (np treats them as ties) and negative-signed NaNs sort
    first rather than last.

    ``descending=True`` reverses the key order while keeping ties in their
    original input order (which a post-hoc ``[::-1]`` would not): the
    encoded keys are bit-complemented (an order-reversing involution on the
    unsigned domain) before and after an ascending stable sort.
    """
    if keys.ndim == 2:
        # np.sort-style batched semantics: every row sorts independently via
        # the segment path (backend selection does not apply there)
        if backend is not None:
            raise ValueError("2-D keys route to sort_segments; backend= does not apply")
        return sort_segments(keys, descending=descending)
    if keys.ndim != 1:
        raise ValueError(f"sort expects 1-D or 2-D keys, got shape {keys.shape}")
    path = _route(backend)
    out, _ = _sort_encoded(_encode(keys, descending), (), path)
    return _decode(out, keys.dtype, descending)


def sort_pairs(
    keys: jnp.ndarray,
    values: jnp.ndarray,
    *,
    backend: str | None = None,
    descending: bool = False,
    stable: bool = True,
):
    """Stable key-value sort; values ride along with their keys.

    ``values`` may be one array or a tuple/list of arrays (all length-N):
    every payload plane is permuted by the same stable key order in ONE
    sort. Returns ``(sorted_keys, values_like)`` with the same container
    shape.

    ``stable=False`` relaxes the tie order (any permutation of equal keys
    is a valid result). Under ``jax_enable_x64``, 32-bit-encoded keys with
    ONE 4-byte payload then pack into a single u64 for a keys-only sort;
    every other configuration runs the stable path (also a valid unstable
    answer).
    """
    multi = isinstance(values, (tuple, list))
    vals = tuple(values) if multi else (values,)
    if keys.ndim == 2:
        if backend is not None:
            raise ValueError("2-D keys route to sort_segments; backend= does not apply")
        return sort_segments(keys, values, descending=descending)
    if keys.ndim != 1 or any(v.shape[:1] != keys.shape[:1] for v in vals):
        raise ValueError(
            "sort_pairs expects matching 1-D arrays, got "
            f"{keys.shape} / {[v.shape for v in vals]}"
        )
    path = _route(backend)
    enc = _encode(keys, descending)
    if (
        not stable
        and not multi
        and path == "tiled"
        and jax.config.jax_enable_x64
        and sortable_dtype(keys.dtype) == jnp.dtype(jnp.uint32)
        and vals[0].dtype.itemsize == 4
    ):
        vbits = vals[0].view(jnp.uint32)
        packed = (enc.astype(jnp.uint64) << np.uint64(32)) | vbits.astype(jnp.uint64)
        sp = segsort.sort_flat(packed)
        out_k = (sp >> np.uint64(32)).astype(jnp.uint32)
        out_v = (sp & np.uint64(0xFFFFFFFF)).astype(jnp.uint32).view(vals[0].dtype)
        return _decode(out_k, keys.dtype, descending), out_v
    out_k, out_vs = _sort_encoded(enc, vals, path)
    keys_out = _decode(out_k, keys.dtype, descending)
    return keys_out, (type(values)(out_vs) if multi else out_vs[0])


def argsort(
    keys: jnp.ndarray,
    *,
    backend: str | None = None,
    descending: bool = False,
) -> jnp.ndarray:
    """Stable argsort indices (uint32 for N < 2^32).

    Under ``jax_enable_x64``, 32-bit-encoded keys pack
    ``(encoded_key << 32) | position`` into one u64 and run a keys-only
    sort: all packed keys are distinct, so an UNSTABLE sort is stable by
    construction. Otherwise the positions ride a stable key-value sort.
    """
    if keys.ndim == 2:
        if backend is not None:
            raise ValueError("2-D keys route to sort_segments; backend= does not apply")
        idx = jnp.broadcast_to(
            jnp.arange(keys.shape[1], dtype=jnp.uint32), keys.shape
        )
        _, perm = sort_segments(keys, idx, descending=descending)
        return perm
    if keys.ndim != 1:
        raise ValueError(f"argsort expects 1-D or 2-D keys, got shape {keys.shape}")
    n = keys.shape[0]
    path = _route(backend)
    if (
        path == "tiled"
        and jax.config.jax_enable_x64
        and n < (1 << 32)
        # dtype metadata decides eligibility BEFORE encoding: encoding and
        # then discarding for 64-bit keys would waste a full-array pass
        and sortable_dtype(keys.dtype) == jnp.dtype(jnp.uint32)
    ):
        enc = _encode(keys, descending)
        idx = jnp.arange(n, dtype=jnp.uint64)
        packed = (enc.astype(jnp.uint64) << np.uint64(32)) | idx
        sp = segsort.sort_flat(packed)
        return (sp & np.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    idx_dtype = jnp.uint32 if n < (1 << 32) else jnp.uint64
    idx = jnp.arange(n, dtype=idx_dtype)
    _, perm = sort_pairs(keys, idx, backend=backend, descending=descending)
    return perm


def sort_segments(
    keys: jnp.ndarray,
    values: jnp.ndarray | None = None,
    *,
    descending: bool = False,
):
    """Sort every row of a 2-D array independently (batched segment sort).

    All rows go through ONE batched ``lax.sort`` along the last axis. The
    reference has no segmented entry point; it is the building block of
    per-partition sorts.

    Stable per row when ``values`` ride along; like :func:`sort_pairs`,
    ``values`` may be one 2-D array or a tuple/list of payload planes.
    Returns ``sorted_keys`` or ``(sorted_keys, permuted_values)`` with the
    container shape preserved.
    """
    if keys.ndim != 2:
        raise ValueError(f"sort_segments expects 2-D keys, got {keys.shape}")
    multi = isinstance(values, (tuple, list))
    vals = () if values is None else (tuple(values) if multi else (values,))
    out_enc, out_vs = segsort.sort_segments(_encode(keys, descending), vals)
    out_k = _decode(out_enc, keys.dtype, descending)
    if values is None:
        return out_k
    return out_k, (type(values)(out_vs) if multi else out_vs[0])
