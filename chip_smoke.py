"""Start-up proof on NVIDIA GPUs: the public entry points at real sizes,
each checked exact against a host oracle.

    python chip_smoke.py               # one card: every single-device phase
    python chip_smoke.py --four-cards  # four cards: the sort_sharded exchange

One process drives the card(s). Phase 0 refuses to run unless JAX's first
device is a GPU (there is no CPU fallback), then prints the platform, the
device kind and count, the card's name and power limit (from ``nvidia-smi``
in a child process that does not import JAX) and the compile cache's
location. Every phase then prints one JSON line: the median wall time of
fenced calls after a warm-up, the rate, the compile time, the device's
running ``peak_bytes_in_use``, the executable's own buffer bytes, and how
many sorts in the compiled HLO are CUB radix-sort custom calls and how many
are XLA's own sort kernel. A failed phase is reported and the run goes on,
but the script then exits 1 without the result line. The last line of a
clean run is exactly ``{"ok": true, "device": {...}}``.

Checks are exact and in full. For a stable key-value sort with positional
payloads, ``perm`` (the payload that came back) is the stable order iff it
is a permutation, ``keys[perm]`` equals the returned keys, those keys never
decrease, and ``perm`` increases across every run of equal keys: the stable
order is unique, so these O(n) host checks prove bitwise equality with the
numpy stable argsort without running it at 1e9.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

import vkradixsort_tpu as vk
from vkradixsort_tpu.engine.context import DeviceContext, use_compile_cache
from vkradixsort_tpu.parallel.distributed import gather_sorted, sort_sharded
from vkradixsort_tpu.utils.fixtures import make_keys
from vkradixsort_tpu.utils.timing import median_seconds

SEED = 0x5EED
SEGMENT = 2048
N_SHARDED = 10**9


def card_name_and_power() -> str:
    """``name, power.limit`` of every visible card, one per line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def require_gpu(devices) -> None:
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "no device"
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {found}")


# --- exact host checks ------------------------------------------------------


def check_permutation(perm: np.ndarray, n: int) -> None:
    assert perm.shape == (n,), f"permutation shape {perm.shape} != ({n},)"
    if n == 0:
        return
    assert int(perm.max()) < n, "index out of range"
    seen = np.zeros(n, bool)
    seen[perm] = True
    assert seen.all(), "payload positions are not a permutation"


def check_pairs(keys: np.ndarray, out_k: np.ndarray, perm: np.ndarray,
                stable: bool = True) -> None:
    """``(out_k, perm)`` is the (stable) ascending sort of ``keys``."""
    check_permutation(perm, keys.size)
    assert np.array_equal(keys[perm], out_k), "keys and payloads are not paired"
    assert np.all(out_k[1:] >= out_k[:-1]), "keys out of order"
    if stable:
        ties = out_k[1:] == out_k[:-1]
        assert np.all(perm[1:][ties] > perm[:-1][ties]), "equal keys out of input order"


def check_keys(keys: np.ndarray, out: np.ndarray) -> None:
    assert np.array_equal(out, np.sort(keys)), "sorted keys differ from np.sort"


# --- single-device phases: (rng, n) -> (fn, args, check) ---------------------


def _uniform(rng, n, dtype=np.uint32):
    return make_keys(rng, n, dtype, "uniform")


def keys_u32(rng, n):
    k = _uniform(rng, n)
    return vk.sort, (jnp.asarray(k),), lambda out: check_keys(k, out)


def keys_f32(rng, n):
    k = rng.standard_normal(n, dtype=np.float32)
    return vk.sort, (jnp.asarray(k),), lambda out: check_keys(k, out)


def keys_u64_zipf(rng, n):
    k = make_keys(rng, n, np.uint64, "zipf")
    return vk.sort, (jnp.asarray(k),), lambda out: check_keys(k, out)


def _kv(keys, payload_dtype=np.uint32, stable=True):
    pos = np.arange(keys.size, dtype=payload_dtype)

    def fn(k, v):
        return vk.sort_pairs(k, v, stable=stable)

    def check(out):
        check_pairs(keys, out[0], out[1], stable=stable)

    return fn, (jnp.asarray(keys), jnp.asarray(pos)), check


def kv_u32(rng, n):
    return _kv(_uniform(rng, n))


def kv_u32_unstable(rng, n):
    return _kv(_uniform(rng, n), stable=False)


def kv_u32_zipf(rng, n):
    return _kv(make_keys(rng, n, np.uint32, "zipf"))


def kv_u64(rng, n):
    return _kv(_uniform(rng, n, np.uint64))


def kv_u32_u64_payload(rng, n):
    return _kv(_uniform(rng, n), payload_dtype=np.uint64)


def kv_u32_two_payloads(rng, n):
    k = _uniform(rng, n)
    pos = np.arange(n, dtype=np.uint32)

    def fn(k, p, q):
        return vk.sort_pairs(k, (p, q))

    def check(out):
        out_k, (out_p, out_q) = out
        check_pairs(k, out_k, out_p)
        assert np.array_equal(out_q, ~out_p), "second payload plane not carried"

    return fn, (jnp.asarray(k), jnp.asarray(pos), jnp.asarray(~pos)), check


def argsort_u32(rng, n):
    k = _uniform(rng, n)
    return vk.argsort, (jnp.asarray(k),), lambda perm: check_pairs(k, k[perm], perm)


def segments_kv(rng, n):
    rows = max(n // SEGMENT, 1)
    k = _uniform(rng, rows * SEGMENT).reshape(rows, SEGMENT)
    col = np.broadcast_to(np.arange(SEGMENT, dtype=np.uint32), k.shape)

    def check(out):
        out_k, out_c = out
        assert int(out_c.max()) < SEGMENT, "payload left its row"
        flat = (out_c.astype(np.int64) + np.arange(rows, dtype=np.int64)[:, None] * SEGMENT)
        check_permutation(flat.reshape(-1), k.size)
        assert np.array_equal(np.take_along_axis(k, out_c.astype(np.int64), 1), out_k), (
            "keys and payloads are not paired")
        assert np.all(out_k[:, 1:] >= out_k[:, :-1]), "row keys out of order"
        ties = out_k[:, 1:] == out_k[:, :-1]
        assert np.all(out_c[:, 1:][ties] > out_c[:, :-1][ties]), "row ties out of order"

    return vk.sort_segments, (jnp.asarray(k), jnp.asarray(col)), check


# (name, phase, n) at the BASELINE.json sizes, plus the routed ops
PHASES = (
    ("u32_keys_1e4", keys_u32, 10**4),
    ("u32_keys_1e6", keys_u32, 10**6),
    ("u32_kv_stable_1e8", kv_u32, 10**8),
    ("u32_kv_unstable_1e8", kv_u32_unstable, 10**8),
    ("u32_argsort_1e8", argsort_u32, 10**8),
    ("f32_keys_1e8", keys_f32, 10**8),
    ("u64_keys_zipf_1e8", keys_u64_zipf, 10**8),
    ("u64_kv_1e8", kv_u64, 10**8),
    ("u32_kv_two_payloads_1e8", kv_u32_two_payloads, 10**8),
    ("u32_kv_u64_payload_1e8", kv_u32_u64_payload, 10**8),
    ("u32_kv_zipf_1e8", kv_u32_zipf, 10**8),
    ("segments_2048_kv_1e8", segments_kv, 10**8),
)


# --- running and reporting --------------------------------------------------


def sort_kinds(hlo_text: str) -> dict:
    """How the compiled program sorts: CUB radix-sort custom calls vs XLA's
    own sort instructions."""
    return {
        "cub_sorts": len(re.findall(r'custom_call_target="[^"]*DeviceRadixSort', hlo_text)),
        "xla_sorts": len(re.findall(r" sort\(", hlo_text)),
    }


def _peak_bytes(devices) -> int | None:
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devices]
    return None if None in peaks else max(peaks)


def _exe_bytes(compiled) -> int | None:
    m = compiled.memory_analysis()
    if m is None:
        return None
    return (m.argument_size_in_bytes + m.output_size_in_bytes
            + m.temp_size_in_bytes)


def run_phase(name: str, fn, args, check, n: int, devices, card: str,
              reps: int = 10) -> dict:
    """Compile, check exact once, then time ``reps`` fenced calls."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.tree.map(np.asarray, compiled(*args))
    check(out)
    del out
    seconds = median_seconds(compiled, *args, reps=reps)
    return {
        "phase": name,
        "n": n,
        "ok": True,
        "median_ms": seconds * 1e3,
        "rate_M_per_s": n / seconds / 1e6,
        "compile_s": compile_s,
        "peak_bytes_in_use": _peak_bytes(devices),
        "exe_bytes": _exe_bytes(compiled),
        **sort_kinds(compiled.as_text()),
        "card": card,
    }


def sharded_kv(rng, n, devices):
    """``sort_sharded`` of ``n`` u32 kv pairs over a 1-D mesh of ``devices``,
    with ``overlap_chunks`` 1 and 2: yields ``(name, fn, args, check)``."""
    mesh = DeviceContext(devices).mesh_1d("x")
    spec = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("x"))
    keys_np = _uniform(rng, n)
    keys = jax.device_put(keys_np, spec)
    pos = jax.jit(lambda: jnp.arange(n, dtype=jnp.uint32), out_shardings=spec)()
    for chunks in (1, 2):
        def fn(k, v, _c=chunks):
            return sort_sharded(k, mesh, values=v, overlap_chunks=_c)

        def check(out, _c=chunks):
            pk, counts, overflow, pv = out
            assert not overflow.any(), f"bucket overflow (overlap_chunks={_c})"
            got_k, got_v = gather_sorted(pk, counts, pv)
            check_pairs(keys_np, got_k, got_v)
            print(f"sharded overlap_chunks={_c}: balance "
                  f"{counts.max() / counts.mean():.4f}, counts {counts.tolist()}",
                  flush=True)

        yield f"sharded_u32_kv_{len(devices)}dev_c{chunks}", fn, (keys, pos), check


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only sort_sharded of 1e9 kv pairs over four cards")
    args = ap.parse_args(argv)

    jax.config.update("jax_enable_x64", True)  # the 64-bit phases
    devices = jax.devices()
    require_gpu(devices)
    cache = use_compile_cache()
    d0 = devices[0]
    print(f"platform={d0.platform} kind={d0.device_kind} count={len(devices)}")
    card = card_name_and_power()
    print(card)
    print(f"compile cache: {cache}", flush=True)
    card = card.splitlines()[0]

    rng = np.random.default_rng(SEED)
    if args.four_cards:
        if len(devices) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, JAX found {len(devices)}")
        jobs = [
            (name, lambda _p=(fn, fargs, check): _p, N_SHARDED, devices[:4], 3)
            for name, fn, fargs, check in sharded_kv(rng, N_SHARDED, devices[:4])
        ]
    else:
        jobs = [
            (name, lambda _ph=phase, _n=n: _ph(rng, _n), n, devices[:1], 10)
            for name, phase, n in PHASES
        ]

    failed = []
    for name, build, n, devs, reps in jobs:
        try:
            rec = run_phase(name, *build(), n, devs, card, reps=reps)
        except Exception:  # report every phase; any failure fails the run
            traceback.print_exc()
            failed.append(name)
            print(json.dumps({"phase": name, "ok": False, "card": card}), flush=True)
            continue
        print(json.dumps(rec), flush=True)

    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind, "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
