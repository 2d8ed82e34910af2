"""Public API dispatch: the routing rule, and both paths' exact results.

The reference validates each program against std::sort separately
(SingleRadixSort.cpp:113-126, MultiRadixSort.cpp:148-161); here one suite
drives both paths through the same public entry points.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import vkradixsort_tpu as vk
from tests.conftest import make_keys
from vkradixsort_tpu.ops import dispatch, reference

ENGINES = ["tiled", "reference"]
REMOVED_ENGINES = ["merge", "bitonic", "fused", "samplesort", "radix_tiled"]


@pytest.mark.parametrize("engine", ENGINES)
def test_sort_engines_exact(rng, engine):
    k = make_keys(rng, 20_000, np.uint32, "uniform")
    out = np.asarray(vk.sort(jnp.asarray(k), backend=engine))
    np.testing.assert_array_equal(out, np.sort(k))


@pytest.mark.parametrize("engine", ENGINES)
def test_sort_pairs_engines_stable(rng, engine):
    k = make_keys(rng, 8_192, np.uint32, "uniform") % 97  # heavy ties
    v = np.arange(k.size, dtype=np.uint32)
    ok, ov = vk.sort_pairs(jnp.asarray(k), jnp.asarray(v), backend=engine)
    perm = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(np.asarray(ok), k[perm])
    np.testing.assert_array_equal(np.asarray(ov), perm.astype(np.uint32))


def test_unknown_backend_raises(rng):
    k = jnp.asarray(make_keys(rng, 128, np.uint32, "uniform"))
    with pytest.raises(ValueError, match="unknown backend"):
        vk.sort(k, backend="quantum")


def test_default_route_every_dtype(rng):
    # Default routing must be exact for every supported dtype, float64
    # included.
    for dtype in [np.uint32, np.int32, np.float32, np.uint64, np.int64, np.float64]:
        k = make_keys(rng, 4_096, np.dtype(dtype).newbyteorder("="), "uniform")
        out = np.asarray(vk.sort(jnp.asarray(k)))
        np.testing.assert_array_equal(out, np.sort(k))


def test_sort_descending_exact(rng):
    for dtype in [np.uint32, np.int32, np.float32]:
        k = make_keys(rng, 4_096, np.dtype(dtype).newbyteorder("="), "uniform")
        out = np.asarray(vk.sort(jnp.asarray(k), descending=True))
        np.testing.assert_array_equal(out, np.sort(k)[::-1])


def test_sort_pairs_descending_stable(rng):
    # Stable descending: ties keep ORIGINAL input order (a [::-1] of the
    # ascending result would reverse ties too). Expected permutation is the
    # stable argsort of the bit-complemented keys.
    k = make_keys(rng, 8_192, np.uint32, "uniform") % 97
    v = np.arange(k.size, dtype=np.uint32)
    ok, ov = vk.sort_pairs(jnp.asarray(k), jnp.asarray(v), descending=True)
    perm = np.argsort(~k, kind="stable")
    np.testing.assert_array_equal(np.asarray(ok), k[perm])
    np.testing.assert_array_equal(np.asarray(ov), perm.astype(np.uint32))
    agot = np.asarray(vk.argsort(jnp.asarray(k), descending=True))
    np.testing.assert_array_equal(agot, perm.astype(np.uint32))


def test_sort_segments_descending(rng):
    k = make_keys(rng, 8_192, np.uint32, "uniform").reshape(8, 1024) % 997
    v = np.tile(np.arange(1024, dtype=np.uint32), (8, 1))
    ok, ov = vk.sort_segments(jnp.asarray(k), jnp.asarray(v), descending=True)
    for r in range(8):
        perm = np.argsort(~k[r], kind="stable")
        np.testing.assert_array_equal(np.asarray(ok)[r], k[r][perm])
        np.testing.assert_array_equal(np.asarray(ov)[r], perm.astype(np.uint32))


def test_sort_pairs_multi_payload(rng):
    # Several payload planes of different dtypes ride one stable key sort.
    k = make_keys(rng, 8_192, np.uint32, "uniform") % 211
    v1 = np.arange(k.size, dtype=np.uint32)
    v2 = rng.standard_normal(k.size).astype(np.float32)
    v3 = (k % 7).astype(np.int32)
    perm = np.argsort(k, kind="stable")
    for engine in ENGINES:
        ok, (o1, o2, o3) = vk.sort_pairs(
            jnp.asarray(k),
            (jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(v3)),
            backend=engine,
        )
        np.testing.assert_array_equal(np.asarray(ok), k[perm], err_msg=engine)
        np.testing.assert_array_equal(np.asarray(o1), v1[perm], err_msg=engine)
        np.testing.assert_array_equal(np.asarray(o2), v2[perm], err_msg=engine)
        np.testing.assert_array_equal(np.asarray(o3), v3[perm], err_msg=engine)


def test_sort_segments_multi_payload(rng):
    k = make_keys(rng, 4_096, np.uint32, "uniform").reshape(4, 1024) % 211
    v1 = np.tile(np.arange(1024, dtype=np.uint32), (4, 1))
    v2 = rng.standard_normal((4, 1024)).astype(np.float32)
    ok, (o1, o2) = vk.sort_segments(jnp.asarray(k), (jnp.asarray(v1), jnp.asarray(v2)))
    for r in range(4):
        perm = np.argsort(k[r], kind="stable")
        np.testing.assert_array_equal(np.asarray(ok)[r], k[r][perm])
        np.testing.assert_array_equal(np.asarray(o1)[r], perm.astype(np.uint32))
        np.testing.assert_array_equal(np.asarray(o2)[r], v2[r][perm])


def test_sort_pairs_unstable_packed(rng, monkeypatch):
    # stable=False + u32-encoded keys + one 4-byte payload packs (key,value)
    # into one u64. Keys must come back sorted and the (key, value) pair
    # multiset preserved; a spy proves the packed route fired.
    from vkradixsort_tpu.ops import segsort

    calls = []
    real = segsort.sort_flat
    monkeypatch.setattr(
        segsort, "sort_flat", lambda *a, **kw: (calls.append(1), real(*a, **kw))[1]
    )
    k = make_keys(rng, 30_000, np.uint32, "uniform") % 977
    v = rng.standard_normal(k.size).astype(np.float32)
    ok, ov = vk.sort_pairs(
        jnp.asarray(k), jnp.asarray(v), backend="tiled", stable=False
    )
    ok, ov = np.asarray(ok), np.asarray(ov)
    assert calls, "packed unstable route did not fire"
    np.testing.assert_array_equal(ok, np.sort(k))
    pin = np.sort((k.astype(np.uint64) << 32) | v.view(np.uint32))
    pout = np.sort((ok.astype(np.uint64) << 32) | ov.view(np.uint32))
    np.testing.assert_array_equal(pin, pout)

    # descending composes
    okd, ovd = vk.sort_pairs(
        jnp.asarray(k), jnp.asarray(v), backend="tiled",
        stable=False, descending=True,
    )
    np.testing.assert_array_equal(np.asarray(okd), np.sort(k)[::-1])


def test_2d_inputs_route_to_segments(rng):
    # np.sort-style batched semantics: 2-D keys sort per row through the
    # segment engine from every public entry point.
    k = make_keys(rng, 8_192, np.uint32, "uniform").reshape(8, 1024) % 211
    v = np.tile(np.arange(1024, dtype=np.uint32), (8, 1))
    np.testing.assert_array_equal(
        np.asarray(vk.sort(jnp.asarray(k))), np.sort(k, axis=1)
    )
    ok, ov = vk.sort_pairs(jnp.asarray(k), jnp.asarray(v))
    perm2d = np.argsort(k, axis=1, kind="stable")
    np.testing.assert_array_equal(np.asarray(ok), np.sort(k, axis=1))
    np.testing.assert_array_equal(np.asarray(ov), perm2d.astype(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(vk.argsort(jnp.asarray(k))), perm2d.astype(np.uint32)
    )
    with pytest.raises(ValueError, match="backend"):
        vk.sort(jnp.asarray(k), backend="tiled")


def test_argsort_stable_all_engines(rng):
    k = make_keys(rng, 4_096, np.uint32, "uniform") % 13
    for engine in ENGINES:
        perm = np.asarray(vk.argsort(jnp.asarray(k), backend=engine))
        np.testing.assert_array_equal(perm, np.argsort(k, kind="stable"))


def test_argsort_packed_fast_path(rng, monkeypatch):
    # backend="tiled" + x64 on (conftest) + 32-bit-encoded keys hits the
    # packed (key<<32 | position) i64 fast path; heavy ties prove the
    # position tiebreak delivers the STABLE permutation, and float32 keys
    # prove it composes with the total-order encoding. A spy on
    # segsort.sort_flat asserts the fast ROUTE actually fired — the
    # fallback carry path would return the identical permutation and
    # silently hide a dead fast path.
    from vkradixsort_tpu.ops import segsort

    calls = []
    real_sort_flat = segsort.sort_flat
    monkeypatch.setattr(
        segsort,
        "sort_flat",
        lambda *a, **kw: (calls.append(1), real_sort_flat(*a, **kw))[1],
    )

    k = make_keys(rng, 50_000, np.uint32, "uniform") % 7
    perm = np.asarray(vk.argsort(jnp.asarray(k), backend="tiled"))
    np.testing.assert_array_equal(perm, np.argsort(k, kind="stable"))
    assert calls, "packed argsort fast path did not fire"

    kf = rng.standard_normal(50_000).astype(np.float32)
    kf[::17] = kf[0]  # ties
    permf = np.asarray(vk.argsort(jnp.asarray(kf), backend="tiled"))
    np.testing.assert_array_equal(permf, np.argsort(kf, kind="stable"))

    # descending via the complement composes with the packed path
    permd = np.asarray(
        vk.argsort(jnp.asarray(k), backend="tiled", descending=True)
    )
    np.testing.assert_array_equal(permd, np.argsort(~k, kind="stable"))


# --- the routing rule -------------------------------------------------------

ENTRY_POINTS = {
    "sort": lambda k, **kw: vk.sort(k, **kw),
    "sort_pairs": lambda k, **kw: vk.sort_pairs(k, jnp.arange(k.shape[0], dtype=jnp.uint32), **kw),
    "sort_pairs_unstable": lambda k, **kw: vk.sort_pairs(
        k, jnp.arange(k.shape[0], dtype=jnp.uint32), stable=False, **kw),
    "sort_pairs_multi": lambda k, **kw: vk.sort_pairs(
        k, (jnp.arange(k.shape[0], dtype=jnp.uint32), k), **kw),
    "argsort": lambda k, **kw: vk.argsort(k, **kw),
}


def test_route_rule():
    assert dispatch._route(None) == "tiled"
    assert dispatch._route("tiled") == "tiled"
    assert dispatch._route("reference") == "reference"


@pytest.mark.parametrize("dtype", [np.uint32, np.float32, np.uint64, np.int64])
@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_default_route_never_reaches_reference(rng, monkeypatch, entry, dtype):
    # backend=None must run the XLA path on every platform: the jnp oracle
    # is never a device default
    def refuse(*a, **kw):
        raise AssertionError("backend=None reached the reference oracle")

    monkeypatch.setattr(reference, "_sort_encoded", refuse)
    k = make_keys(rng, 1_000, dtype, "uniform")
    out = ENTRY_POINTS[entry](jnp.asarray(k))
    first = np.asarray(out[0] if isinstance(out, tuple) else out)
    want = np.argsort(k, kind="stable") if entry == "argsort" else np.sort(k)
    np.testing.assert_array_equal(first, want)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_explicit_reference_backend_runs_the_oracle(rng, monkeypatch, entry):
    calls = []
    real = reference._sort_encoded
    monkeypatch.setattr(
        reference, "_sort_encoded",
        lambda *a, **kw: (calls.append(1), real(*a, **kw))[1],
    )
    k = make_keys(rng, 1_000, np.uint32, "uniform") % 31
    out = ENTRY_POINTS[entry](jnp.asarray(k), backend="reference")
    assert calls, "backend='reference' did not run the oracle"
    first = np.asarray(out[0] if isinstance(out, tuple) else out)
    want = np.argsort(k, kind="stable") if entry == "argsort" else np.sort(k)
    np.testing.assert_array_equal(first, want)


@pytest.mark.parametrize("engine", REMOVED_ENGINES)
@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_removed_engine_raises(entry, engine):
    k = jnp.arange(64, dtype=jnp.uint32)
    with pytest.raises(ValueError, match="unknown backend"):
        ENTRY_POINTS[entry](k, backend=engine)
