import os
import sys

# Run the test-suite on a virtual 8-device CPU mesh so multi-device sharding
# logic is exercised without accelerators (SURVEY.md §4: the serial-vs-sharded
# equivalence strategy; JAX's host-device-count override).
os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# jax may already have been imported (and read JAX_PLATFORMS) before this
# file ran; pin the platform through the config API before any backend
# initializes.
jax.config.update("jax_platforms", "cpu")

# Reference-grade precision for numerical assertions.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import oceananigans_tpu  # noqa: E402
from oceananigans_tpu.defaults import defaults  # noqa: E402
from oceananigans_tpu.platform import configure_compilation_cache  # noqa: E402

# Persistent compilation cache: repeated test runs skip recompilation.
configure_compilation_cache()

defaults.FloatType = np.float64


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def pytest_collection_modifyitems(config, items):
    """Two-tier suite (the analogue of the reference's runtests.jl group
    sharding): the DEFAULT tier skips `slow`-marked study/equivalence
    batteries so `pytest tests` finishes in minutes; the FULL tier runs
    everything. Opt in to the full tier with OCEANANIGANS_TPU_FULL_SUITE=1
    (or select explicitly with -m, which always wins)."""
    if os.environ.get("OCEANANIGANS_TPU_FULL_SUITE"):
        return
    if config.getoption("-m"):
        return
    skip = pytest.mark.skip(
        reason="slow tier (set OCEANANIGANS_TPU_FULL_SUITE=1 or -m slow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
