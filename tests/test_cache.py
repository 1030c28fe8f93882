"""Where the persistent compilation cache lands (utils/cache.py)."""
import os

import jax
import pytest

from sph_mountain_waves_tpu.utils import cache


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_uses_env_dir_untouched(monkeypatch, tmp_path,
                                      restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set the cache is that directory and
    the module configures nothing."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_persistent_cache(cpu_too=True) == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_checkout(monkeypatch, restore_cache_config):
    """Without it the cache is <checkout>/.jax_cache, next to the package,
    whatever the working directory."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    import sph_mountain_waves_tpu as pkg
    repo = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    expect = os.path.join(repo, ".jax_cache")
    assert cache.DEFAULT_DIR == expect
    assert cache.enable_persistent_cache(cpu_too=True) == expect
    assert jax.config.jax_compilation_cache_dir == expect
    assert cache.enable_persistent_cache() is None   # CPU: off by default
