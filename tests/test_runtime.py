"""Entry-point set-up helpers (utils/runtime.py): compile cache and the GPU
guard."""

import jax
import pytest

from point_cloud_registration_tpu.utils import runtime


@pytest.fixture
def cache_config():
    """Restore JAX's cache-dir setting after the test."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_set_is_left_to_jax(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    # nothing set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == str(runtime.CHECKOUT_CACHE_DIR)
    assert runtime.CHECKOUT_CACHE_DIR.name == ".jax_cache"
    assert (runtime.CHECKOUT_CACHE_DIR.parent / "point_cloud_registration_tpu").is_dir()
    assert jax.config.jax_compilation_cache_dir == path


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()
