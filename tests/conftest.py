"""Test harness configuration.

Tests run on a simulated 8-device CPU platform so sharding/collective code
paths are exercised without accelerator hardware. Must run before the first
``import jax`` touches the backend.
"""

import os

# Force CPU, through both the env var and the config flag, before backend
# init: on a machine with a GPU every tiny test jit would otherwise compile
# for (and hold) the card.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    A full-suite run accumulates a few hundred XLA:CPU programs in one
    process; with all of them live, the LLVM JIT has segfaulted compiling
    the suite's biggest programs — deterministically in-suite, never
    standalone. Dropping executables between modules keeps per-module state
    bounded; within-module caching (the expensive repeated programs) is
    unaffected.
    """
    yield
    jax.clear_caches()
