"""Persistent compiled-program cache.

JAX's persistent compilation cache stores the serialized compiled
executable keyed on (program, compile options, backend version), so every
process after the first pays a cache read instead of a compile: the
flagship step and the parity sweeps compile once per program shape, not
once per run.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
module sets nothing. Otherwise the cache lives at ``<checkout>/.jax_cache``,
a fixed path derived from the package's own location, so the next process
finds the entries again.

Call :func:`enable_persistent_cache` before building any jitted program.
Used by chip_smoke.py, bench.py and scripts/bench_all.py; safe to call
multiple times.
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_persistent_cache(path: str | None = None,
                            min_compile_secs: float = 5.0,
                            cpu_too: bool = False) -> str | None:
    """Turn on JAX's compilation cache; return its directory (or None).

    ``path``: the directory; default ``JAX_COMPILATION_CACHE_DIR`` when set
    (then left to JAX as it is: nothing is configured), else
    ``DEFAULT_DIR``.

    ``min_compile_secs``: only programs whose compile took at least this
    long are persisted — keeps the cache to the handful of expensive
    production programs instead of thousands of test-sized ones.

    CPU backends are skipped by default (returns None): XLA:CPU AOT
    cache entries embed machine-feature lists including pseudo-features
    that the loader's host check does not recognize, producing warning
    noise on reload — and CPU compiles are cheap anyway. NOTE: the
    backend probe initializes JAX's backends, so call this AFTER any
    ``jax_platforms``/device-count configuration."""
    import jax

    if not cpu_too and jax.default_backend() == "cpu":
        return None
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path is None and env:
        return env
    path = path or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path
