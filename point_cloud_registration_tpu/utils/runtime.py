"""Process set-up for the entry scripts: compile cache and device checks.

Nothing here runs at import; the library itself never calls these. Entry
points (``chip_smoke.py``, ``bench.py``, ``benchmark/*.py``,
``scripts/*.py``) call :func:`enable_compile_cache` before their first
compile, and the measurement paths call :func:`require_gpu`.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

# <checkout>/.jax_cache: a fixed path, so a later process finds what an
# earlier one compiled (the path is part of the cache's key).
CHECKOUT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing; otherwise the cache goes to ``<checkout>/.jax_cache``.
    Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)


def require_gpu():
    """Return ``jax.devices()``, or raise if JAX found no GPU.

    JAX falls back to the CPU with only a warning when its CUDA plugin fails
    to start; a measurement must not silently run there.
    """
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devices[0].platform!r} ({len(devices)} device(s))"
        )
    return devices


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one line
    each (a card set below its maximum power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
