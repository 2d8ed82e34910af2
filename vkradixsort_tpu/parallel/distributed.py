"""Multi-device / multi-host distributed sort (SURVEY.md §7 L5 — a NEW layer,
absent in the single-GPU reference, mandated by BASELINE.json's north star).

Algorithm — MSD-first range partitioning by sampled splitters with an
all-to-all key/value shuffle over the mesh interconnect:

  1. each shard stably sorts its local slice (XLA's tuned segment sort),
  2. every shard contributes an oversampled set of local quantiles;
     the gathered sample's quantiles become the P-1 global splitters
     (oversampling bounds bucket skew whp — the skew-handling knob for
     Zipf-style inputs, BASELINE.json config #4),
  3. splitter positions inside each sorted shard come from vectorized
     searchsorted; bucket p of every shard is a contiguous run,
  4. runs are placed in a (P, cap) sentinel-padded send buffer (static
     shapes; cap = slack * n_local / P) and exchanged with ONE
     ``lax.all_to_all`` over the mesh axis (NCCL over NVLink between the
     GPUs of one host, over the network between hosts),
  5. each shard stably sorts its received buffer; sentinels (key-max)
     sink to the tail. Concatenating shards (minus sentinels) is the
     exact stable global sort.

Stability: pieces arrive ordered by source shard and are locally
key-stable, so the pre-final-sort concat order equals the original global
order among equal keys; the final stable sort preserves it.

Overflow: a bucket larger than cap cannot be represented; ``sort_sharded``
returns a per-shard overflow flag as part of its result and the CALLER must
check it (it is a traced value) and retry with a larger ``slack`` /
``oversample`` if any entry is set.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from vkradixsort_tpu.ops import segsort
from vkradixsort_tpu.ops.common import (
    composite_searchsorted,
    decode_keys,
    encode_keys,
    pad_sentinel,
)

P = jax.sharding.PartitionSpec


def _quantile_positions(n: int, m: int) -> jnp.ndarray:
    """m regular sample positions (bucket midpoints) in [0, n).

    Computed on the host in int64: both sizes are static, and ``i * n``
    overflows int32 once a shard holds more than 2^31 / m elements."""
    pos = (np.arange(m, dtype=np.int64) * n) // m + n // (2 * m)
    return jnp.asarray(np.minimum(pos, n - 1), jnp.int32)


def _global_quantiles(local_k, local_g, axis_name, num_shards):
    """all_gather every shard's local splitter candidates, sort the pooled
    composite (key, position) sample, and return its P-1 global quantiles."""
    all_k = jax.lax.all_gather(local_k, axis_name).reshape(-1)
    all_g = jax.lax.all_gather(local_g, axis_name).reshape(-1)
    sk, sg, _ = _idx_sort(all_k, all_g, [])
    step = max(all_k.shape[0] // num_shards, 1)
    return sk[step::step][: num_shards - 1], sg[step::step][: num_shards - 1]


def _build_send(
    k_sorted, gidx_s, vs, splitters, splitters_g, num_shards, cap, n_real
):
    """Slice the P contiguous splitter buckets of a sorted shard into
    sentinel-padded static (P, cap) send buffers.

    Returns ``(send_k, send_vs, lens, overflow)``. ``vs`` must already have
    the gidx carry at position 0 (its padding fill is the gidx dtype's max
    so padding sorts strictly AFTER real pairs even inside a sentinel-key
    run; see sort_sharded docstring). ``n_real`` bounds the valid prefix of
    the sorted chunk: internal alignment padding (key sentinel, gidx max)
    sorts to the suffix and is never sent — the receive side's static fill
    is the identical (sentinel, gidx-max, zeros) pattern."""
    sentinel = pad_sentinel(k_sorted.dtype)
    bounds = composite_searchsorted(k_sorted, gidx_s, splitters, splitters_g)
    bounds = jnp.minimum(bounds, n_real)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), bounds])
    ends = jnp.concatenate([bounds, jnp.reshape(n_real, (1,)).astype(jnp.int32)])
    lens = ends - starts
    overflow = jnp.any(lens > cap)

    gfill = np.asarray(np.iinfo(np.dtype(vs[0].dtype)).max, vs[0].dtype)
    fills = [gfill] + [0] * (len(vs) - 1)
    k_ext = jnp.concatenate([k_sorted, jnp.full((cap,), sentinel, k_sorted.dtype)])
    v_exts = [
        jnp.concatenate([v, jnp.full((cap,), fill, v.dtype)])
        for v, fill in zip(vs, fills)
    ]
    jpos = jnp.arange(cap, dtype=jnp.int32)[None, :]  # (1, cap)
    send_k = jnp.stack(
        [jax.lax.dynamic_slice(k_ext, (starts[p],), (cap,)) for p in range(num_shards)]
    )
    valid = jpos < lens[:, None]  # (P, cap)
    send_k = jnp.where(valid, send_k, sentinel)
    send_vs = [
        jnp.where(
            valid,
            jnp.stack(
                [
                    jax.lax.dynamic_slice(v_ext, (starts[p],), (cap,))
                    for p in range(num_shards)
                ]
            ),
            fill,
        )
        for v_ext, fill in zip(v_exts, fills)
    ]
    return send_k, send_vs, lens, overflow


def _partition_fn(
    axis_name: str,
    num_shards: int,
    cap: int,
    oversample: int,
    chunks: int = 1,
    gdt=jnp.int32,
):
    """The per-shard shard_map body. Operates on encoded uint32/64 keys.

    ``chunks=1`` is the plain single-exchange pipeline. ``chunks=K > 1`` is
    the software-pipelined variant (the north star's "exchange overlapped
    with local passes"): the shard splits into K STRIDED sub-arrays
    (element c, c+K, c+2K, ... — a contiguous split would concentrate value
    ranges per chunk and skew its buckets), and each loop step sorts chunk
    k while the all-to-all of chunk k-1's buckets is in flight — the two
    are dataflow-independent inside one step, so XLA's async collectives
    can overlap the exchange with local sorting on real hardware. ``cap``
    is the PER-CHUNK per-bucket capacity. ``gdt`` is the position-carry
    dtype (int64 once global N needs it).

    Local shards are padded internally to a multiple of P*chunks with
    (key-sentinel, gidx-max) pairs, which sort to every chunk's suffix and
    are clipped out of the send stage — callers owe no P^2 or chunk
    divisibility.
    """

    def fn(enc, *values):
        n = enc.shape[0]
        gmax = np.asarray(np.iinfo(np.dtype(gdt)).max, gdt)

        # 0a. Global original positions, carried so stability survives the
        # reshuffles (used as a secondary sort key); alignment padding to
        # the P*chunks grain is marked gidx-max so it sorts after every
        # real pair and is excluded from counts and sends.
        shard_id = jax.lax.axis_index(axis_name)
        gidx = (shard_id.astype(gdt) * n + jnp.arange(n, dtype=gdt)).astype(gdt)
        grain = num_shards * chunks
        npl = ((n + grain - 1) // grain) * grain
        if npl != n:
            sentinel = pad_sentinel(enc.dtype)
            enc = jnp.concatenate(
                [enc, jnp.full((npl - n,), sentinel, enc.dtype)]
            )
            gidx = jnp.concatenate([gidx, jnp.full((npl - n,), gmax, gdt)])
            values = [
                jnp.concatenate([v, jnp.zeros((npl - n,), v.dtype)])
                for v in values
            ]

        # 0b. Block-interleave reshard: one cheap all_to_all that scatters
        # each shard's npl/P sub-blocks round-robin across the mesh, breaking
        # value locality (a descending input would otherwise send a whole
        # shard into ONE bucket and overflow any sub-linear cap).
        def interleave(x):
            return jax.lax.all_to_all(
                x.reshape(num_shards, npl // num_shards),
                axis_name,
                split_axis=0,
                concat_axis=0,
            ).reshape(-1)

        enc = interleave(enc)
        gidx = interleave(gidx)
        values = [interleave(v) for v in values]

        C = chunks
        n_chunk = npl // C

        def chunk(x, c):
            return x.reshape(n_chunk, C)[:, c]

        def a2a(x):
            return jax.lax.all_to_all(x, axis_name, split_axis=0, concat_axis=0)

        def sort_chunk(c):
            # Local sort with the global position as tiebreak key
            # (deterministic total order == stable w.r.t. original layout).
            # The gidx carry rides at vs[0] with padding fill gidx-max in
            # _build_send: a real key can equal the key sentinel, and
            # gidx-max makes padding sort strictly AFTER every real pair
            # inside a sentinel-key run, so such pairs keep their payloads.
            # n_real = valid prefix length (alignment pads sort to the tail).
            kc, gc, vc = _idx_sort(
                chunk(enc, c), chunk(gidx, c), [chunk(v, c) for v in values]
            )
            n_real = (n_chunk - jnp.sum(gc == gmax)).astype(jnp.int32)
            return kc, gc, [gc] + vc, n_real

        k0, g0, vs0, nr0 = sort_chunk(0)

        # Splitter candidates. Composite (key, original-position) splitters
        # split runs of equal keys across buckets, so duplicate-heavy (even
        # constant) inputs stay balanced. At C=1 chunk 0 IS the whole
        # sorted shard, so candidates are its exact quantiles; at C>1 half
        # come from sorted chunk 0 and the rest are raw strided samples
        # from every other chunk — sampling only chunk 0 would let any key
        # pattern periodic in the chunk stride C concentrate the other
        # chunks' buckets arbitrarily far from the chunk-0 estimate.
        num_s = min(oversample * num_shards, n_chunk)
        if C == 1:
            cand_k = jnp.take(k0, _quantile_positions(n_chunk, num_s))
            cand_g = jnp.take(g0, _quantile_positions(n_chunk, num_s))
        else:
            half = max(num_s // 2, 1)
            pos0 = _quantile_positions(n_chunk, half)
            m = max((num_s - half) // (C - 1), 1)
            pos_raw = _quantile_positions(n_chunk, m)
            cand_k = jnp.concatenate(
                [jnp.take(k0, pos0)]
                + [jnp.take(chunk(enc, c), pos_raw) for c in range(1, C)]
            )
            cand_g = jnp.concatenate(
                [jnp.take(g0, pos0)]
                + [jnp.take(chunk(gidx, c), pos_raw) for c in range(1, C)]
            )
        splitters, splitters_g = _global_quantiles(
            cand_k, cand_g, axis_name, num_shards
        )

        # Pipeline: bucket bounds via O(P log n) composite bisection (the
        # chunk is sorted by exactly that composite order), static-shape
        # sentinel-padded send buffers, one all-to-all per chunk. Each
        # step's local sort is independent of the previous chunk's
        # exchange — the overlap window.
        prev = _build_send(
            k0, g0, vs0, splitters, splitters_g, num_shards, cap, nr0
        )
        overflow = prev[3]
        lens_total = prev[2]
        recv_ks, recv_vss = [], []
        for c in range(1, C):
            kc, gc, vsc, nrc = sort_chunk(c)
            recv_ks.append(a2a(prev[0]))
            recv_vss.append([a2a(sv) for sv in prev[1]])
            prev = _build_send(
                kc, gc, vsc, splitters, splitters_g, num_shards, cap, nrc
            )
            overflow = overflow | prev[3]
            lens_total = lens_total + prev[2]
        recv_ks.append(a2a(prev[0]))
        recv_vss.append([a2a(sv) for sv in prev[1]])

        # Tiebreak local sort of everything received; per-chunk sums of
        # lens commute with the elementwise all-to-all, so ONE tiny lens
        # exchange covers all chunks.
        all_k = jnp.concatenate([r.reshape(-1) for r in recv_ks])
        all_g = jnp.concatenate([rv[0].reshape(-1) for rv in recv_vss])
        all_vs = [
            jnp.concatenate([rv[1 + i].reshape(-1) for rv in recv_vss])
            for i in range(len(values))
        ]
        out_k, out_gidx, out_vs = _idx_sort(all_k, all_g, all_vs)
        count = jnp.sum(a2a(lens_total))
        return (out_k, count.reshape(1), overflow.reshape(1)) + tuple(out_vs)

    return fn


def _idx_sort(enc, gidx, values: Sequence[jnp.ndarray]):
    """Sort by (key, original-position): deterministic, globally stable."""
    if enc.dtype == jnp.uint32:
        keys = (segsort.to_signed_order(enc), gidx)
    else:
        lo = (enc & np.uint64(0xFFFFFFFF)).astype(jnp.uint32)
        hi = (enc >> np.uint64(32)).astype(jnp.uint32)
        keys = (
            segsort.to_signed_order(hi),
            segsort.to_signed_order(lo),
            gidx,
        )
    ops = jax.lax.sort(keys + tuple(values), dimension=0, num_keys=len(keys))
    if enc.dtype == jnp.uint32:
        out_k = segsort.from_signed_order(ops[0], jnp.uint32)
        return out_k, ops[1], list(ops[2:])
    hi_s = segsort.from_signed_order(ops[0], jnp.uint32).astype(jnp.uint64)
    lo_s = segsort.from_signed_order(ops[1], jnp.uint32).astype(jnp.uint64)
    out_k = (hi_s << np.uint64(32)) | lo_s
    return out_k, ops[2], list(ops[3:])


def sort_sharded(
    keys: jnp.ndarray,
    mesh: jax.sharding.Mesh,
    values=None,
    axis_name: str = "x",
    slack: float = 2.0,
    oversample: int = 32,
    descending: bool = False,
    overlap_chunks: int = 1,
    gidx_dtype=None,
):
    """Distributed stable sort of a 1-D array sharded over ``axis_name``.

    Returns ``(padded_keys, counts, overflow[, padded_values])``: shard d of
    ``padded_keys`` holds the d-th contiguous range of the globally sorted
    order in its first ``counts[d]`` slots, sentinel-padded after (padding
    content is arbitrary — strip with ``gather_sorted``). ``overflow`` is a
    per-shard flag the caller MUST check: if any entry is set, a bucket
    exceeded its static capacity and the output is truncated — retry with
    larger ``slack``/``oversample`` (or use :func:`sort_distributed`, which
    does that loop). Keys may be any supported key dtype; ``values`` ride
    along unchanged and may be one array or a tuple/list of payload planes
    (``padded_values`` matches the container shape). ``descending=True``
    reverses the key order with ties kept in original input order, via the
    same encoded-key bit-complement as the single-device API.

    ``overlap_chunks=K > 1`` selects the software-pipelined body: each shard
    is split into K strided chunks and the all-to-all of chunk k-1 runs
    dataflow-independent of chunk k's local sort, letting XLA overlap the
    interconnect exchange with local compute (the reference has no
    distribution at all; this is the north-star "exchange overlapped with
    local passes"). Splitters blend chunk 0's sorted quantiles with raw
    strided samples from every other chunk, so balance is slightly looser
    than the K=1 exact-quantile path — same overflow contract.

    Size contract: N must divide by P (the mesh sharding itself); every
    other grain (interleave blocks, chunk splits) is padded internally.
    Global positions carry as int32 below N = 2^31 and as int64 beyond
    (requires x64); ``gidx_dtype=jnp.int64`` opts in explicitly.
    """
    multi = isinstance(values, (tuple, list))
    vals = () if values is None else (tuple(values) if multi else (values,))
    num_shards = mesh.shape[axis_name]
    n = keys.shape[0]
    if n % num_shards:
        raise ValueError(
            f"N={n} must be a multiple of P={num_shards} so the input can "
            "shard evenly over the mesh axis (pad the caller array; any "
            "other divisibility is handled internally)"
        )
    if overlap_chunks < 1:
        raise ValueError(f"overlap_chunks must be >= 1, got {overlap_chunks}")
    # Position-carry dtype: int32 covers global positions below 2^31; larger
    # sorts carry int64 automatically. Opt in explicitly via gidx_dtype to
    # test the wide path at small sizes.
    gdt = jnp.dtype(gidx_dtype) if gidx_dtype is not None else (
        jnp.dtype(jnp.int64) if n >= (1 << 31) - 1 else jnp.dtype(jnp.int32)
    )
    if gdt == jnp.dtype(jnp.int64) and not jax.config.jax_enable_x64:
        raise ValueError(
            "int64 position carries (N >= 2^31 or gidx_dtype=int64) require "
            "jax.config.update('jax_enable_x64', True)"
        )

    enc = encode_keys(keys)
    if descending:
        enc = ~enc
    if n == 0:
        # nothing to exchange: zero counts, no overflow, input passes through
        spec0 = jax.sharding.NamedSharding(mesh, P(axis_name))
        counts = jax.lax.with_sharding_constraint(
            jnp.zeros((num_shards,), jnp.int32), spec0
        )
        overflow = jax.lax.with_sharding_constraint(
            jnp.zeros((num_shards,), jnp.bool_), spec0
        )
        if values is None:
            return keys, counts, overflow
        return keys, counts, overflow, (type(values)(vals) if multi else values)

    grain = num_shards * overlap_chunks
    n_local_padded = ((n // num_shards + grain - 1) // grain) * grain
    cap = int(slack * n_local_padded / (overlap_chunks * num_shards)) + 64
    fn = _partition_fn(axis_name, num_shards, cap, oversample, overlap_chunks, gdt)
    spec = P(axis_name)
    out_specs = (spec, spec, spec) + tuple(spec for _ in vals)
    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(spec,) + tuple(spec for _ in vals),
        out_specs=out_specs,
        check_vma=False,
    )
    res = mapped(enc, *vals)
    out_k, counts, overflow = res[0], res[1], res[2]
    if descending:
        out_k = ~out_k
    out_keys = decode_keys(out_k, keys.dtype)
    if values is None:
        return out_keys, counts, overflow
    return out_keys, counts, overflow, (type(values)(res[3:]) if multi else res[3])


def _to_host(x):
    """Global array -> host ndarray; multi-process-safe (a plain np.asarray
    raises on arrays whose shards live on other hosts)."""
    if jax.process_count() > 1:  # pragma: no cover - needs a live cluster
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def gather_sorted(padded_keys, counts, padded_values=None):
    """Host-side helper: strip sentinel padding and concatenate shards."""
    cs = _to_host(counts)

    def strip(padded):
        p = _to_host(padded)
        per = p.shape[0] // cs.shape[0]
        return np.concatenate([p[i * per : i * per + cs[i]] for i in range(cs.shape[0])])

    out_k = strip(padded_keys)
    if padded_values is None:
        return out_k
    if isinstance(padded_values, (tuple, list)):
        return out_k, type(padded_values)(strip(pv) for pv in padded_values)
    return out_k, strip(padded_values)


def sort_distributed(
    keys: jnp.ndarray,
    mesh: jax.sharding.Mesh,
    values=None,
    axis_name: str = "x",
    slack: float = 2.0,
    oversample: int = 32,
    descending: bool = False,
    overlap_chunks: int = 1,
    gidx_dtype=None,
):
    """Host-driving convenience around :func:`sort_sharded`: runs the
    distributed sort, checks the overflow flag, and retries with doubled
    ``slack`` (and ``oversample``) until it fits. At ``slack >= P`` a bucket
    capacity equals the whole shard, so overflow is impossible and the loop
    always terminates. Returns stripped host arrays — ``sorted_keys`` or
    ``(sorted_keys, values_like)``. Not jit-compatible (it fetches the
    overflow flag); inside jit use ``sort_sharded`` and handle overflow
    yourself.
    """
    num_shards = mesh.shape[axis_name]
    while True:
        res = sort_sharded(
            keys,
            mesh,
            values=values,
            axis_name=axis_name,
            slack=slack,
            oversample=oversample,
            descending=descending,
            overlap_chunks=overlap_chunks,
            gidx_dtype=gidx_dtype,
        )
        # jnp.any reduces to a replicated scalar, fetchable on every host
        if not bool(jnp.any(res[2])):
            if values is None:
                return gather_sorted(res[0], res[1])
            return gather_sorted(res[0], res[1], res[3])
        assert slack < num_shards, "overflow at slack >= P cannot happen"
        slack = min(slack * 2.0, float(num_shards))
        oversample = min(oversample * 2, 256)
