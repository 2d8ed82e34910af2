"""Benchmark driver — prints ONE JSON line with the north-star metric.

Metric (BASELINE.json): pairs/s on one GPU sorting 1e8 uint32 key-value
pairs, stable, checked exact in full against the stable order
(``chip_smoke.check_pairs``). vs_baseline is relative to the reference's
only absolute published number: 52.7M keys/s for 1e6 u32 keys on an
RTX 3070 (reference README.md:256, single_radixsort). The line names the
device and the card's name and power limit.

Extra diagnostics go to stderr; stdout carries exactly one JSON line.
"""

import json
import sys
import traceback

import numpy as np

N = 10**8
REFERENCE_KEYS_PER_S = 52.7e6  # reference README.md:256


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit_failure_json(stage, detail):
    """Contract line on failure: valid JSON with a diagnostic, value 0."""
    print(json.dumps({
        "metric": "u32 kv-pair sort throughput (FAILED)",
        "value": 0,
        "unit": "M pairs/s/card",
        "vs_baseline": 0,
        "error": f"{stage}: {detail}"[:2000],
    }))


def main():
    import jax

    import chip_smoke
    from vkradixsort_tpu.engine.context import use_compile_cache

    devices = jax.devices()
    chip_smoke.require_gpu(devices)
    log(f"compile cache: {use_compile_cache()}")
    card = chip_smoke.card_name_and_power().splitlines()[0]
    d0 = devices[0]
    log(f"devices: {devices}; card: {card}")

    fn, args, check = chip_smoke.kv_u32(np.random.default_rng(0xBE7C), N)
    rec = chip_smoke.run_phase("u32_kv_stable_1e8", fn, args, check, N,
                               devices[:1], card)
    log(json.dumps(rec))
    pairs_per_s = N / (rec["median_ms"] / 1e3)
    print(json.dumps({
        "metric": f"u32 kv-pair sort throughput (N={N:.0e}, one card, stable, exact)",
        "value": pairs_per_s / 1e6,
        "unit": "M pairs/s/card",
        "vs_baseline": pairs_per_s / REFERENCE_KEYS_PER_S,
        "device": {"platform": d0.platform, "kind": d0.device_kind,
                   "count": len(devices)},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except (Exception, SystemExit) as e:  # stdout carries one JSON line, always
        log(traceback.format_exc())
        emit_failure_json(type(e).__name__, str(e))
        sys.exit(1)
    sys.exit(rc)
