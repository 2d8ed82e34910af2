"""chip_smoke.py's phases at tiny size on the CPU, and its refusal to run
without a GPU. The script itself runs on the card (README)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke

TINY = {"u32_keys_1e4": 1_000, "segments_2048_kv_1e8": 3 * chip_smoke.SEGMENT}


@pytest.mark.parametrize("name,phase", [(n, p) for n, p, _ in chip_smoke.PHASES])
def test_phase_exact_at_tiny_size(name, phase):
    n = TINY.get(name, 5_000)
    fn, args, check = phase(np.random.default_rng(chip_smoke.SEED), n)
    rec = chip_smoke.run_phase(name, fn, args, check, n, jax.devices()[:1],
                               "test card", reps=2)
    assert rec["ok"] and rec["phase"] == name and rec["n"] == n
    assert rec["median_ms"] > 0 and rec["rate_M_per_s"] > 0
    # every path sorts through XLA; the CPU backend has no CUB call
    assert rec["xla_sorts"] >= 1 and rec["cub_sorts"] == 0


@pytest.mark.parametrize("n", [4 * 1000, 4 * 997])
def test_sharded_phase_on_four_devices(n):
    devices = jax.devices()[:4]
    runs = list(chip_smoke.sharded_kv(np.random.default_rng(1), n, devices))
    assert [r[0] for r in runs] == ["sharded_u32_kv_4dev_c1", "sharded_u32_kv_4dev_c2"]
    for name, fn, args, check in runs:
        rec = chip_smoke.run_phase(name, fn, args, check, n, devices, "test card",
                                   reps=1)
        assert rec["ok"]


def test_refuses_cpu_device():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu([])


def test_main_refuses_cpu_before_printing(capsys):
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.main([])
    assert capsys.readouterr().out == ""


def test_check_pairs_catches_each_fault():
    keys = np.array([3, 1, 3, 2], np.uint32)
    perm = np.array([1, 3, 0, 2], np.uint32)
    chip_smoke.check_pairs(keys, keys[perm], perm)
    faults = [
        (keys[perm], np.array([1, 3, 2, 0], np.uint32)),  # ties out of order
        (keys[perm], np.array([1, 3, 0, 0], np.uint32)),  # not a permutation
        (np.array([1, 2, 3, 4], np.uint32), perm),         # keys not paired
        (keys[[0, 1, 2, 3]], np.arange(4, dtype=np.uint32)),  # not sorted
    ]
    for out_k, p in faults:
        with pytest.raises(AssertionError):
            chip_smoke.check_pairs(keys, out_k, p)
    # an unstable check accepts either tie order
    chip_smoke.check_pairs(keys, keys[perm], np.array([1, 3, 2, 0], np.uint32),
                           stable=False)


def test_sort_kinds_reads_hlo():
    text = (
        '%cub = (s32[8]{0}, u8[64]{0}) custom-call(s32[8]{0} %p), '
        'custom_call_target="__cub$DeviceRadixSort"\n'
        '%sort.1 = (s32[8]{0}, u32[8]{0}, u32[8]{0}) sort(s32[8]{0} %a, '
        'u32[8]{0} %b, u32[8]{0} %c), dimensions={0}, is_stable=true\n'
    )
    assert chip_smoke.sort_kinds(text) == {"cub_sorts": 1, "xla_sorts": 1}
    hlo = jax.jit(jnp.sort).lower(jnp.arange(8)).compile().as_text()
    assert chip_smoke.sort_kinds(hlo)["xla_sorts"] >= 1


def test_phase_sizes_are_the_real_ones():
    sizes = {name: n for name, _, n in chip_smoke.PHASES}
    assert sizes["u32_keys_1e4"] == 10**4 and sizes["u32_keys_1e6"] == 10**6
    assert all(n == 10**8 for name, n in sizes.items() if name.endswith("1e8"))
    assert chip_smoke.N_SHARDED == 10**9
