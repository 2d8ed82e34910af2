"""Test harness config: the CPU backend with 8 virtual devices.

The reference has no test framework — its example binaries self-verify
against std::sort (SURVEY.md §4). We go further: pytest suites that run
anywhere on the CPU backend with 8 virtual devices, so multi-device sharding
logic is exercised without a GPU cluster (SURVEY.md §4 implication (c)). The
on-card proof is ``chip_smoke.py`` (README).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# the suite runs on the CPU backend even on a machine with a GPU
jax.config.update("jax_platforms", "cpu")
# 64-bit keys (uint64/int64/float64, BASELINE.json config #4) require x64.
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)


# Key fixtures live in the package so benchmarks can use them without
# importing this conftest (which forces the CPU backend).
from vkradixsort_tpu.utils.fixtures import make_keys  # noqa: E402,F401
