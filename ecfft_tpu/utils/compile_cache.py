"""Where JAX keeps its persistent compilation cache for this checkout."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when it is set, else ``.jax_cache`` at
    the root of the checkout that holds this package."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    return it. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
    reads it, and no other directory is set here."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
