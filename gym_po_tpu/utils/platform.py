"""Persistent compilation cache for the entry points.

Cold XLA compiles of the ant engine and the learners take a large share of
a short run, so every bench/driver entry point calls
:func:`enable_compilation_cache`.
"""

from __future__ import annotations

import os

import jax

__all__ = ["compilation_cache_dir", "enable_compilation_cache"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compilation_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``
    (a fixed path: the path is part of the cache key, so it must not
    move between runs)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO, ".jax_cache"
    )


def enable_compilation_cache() -> str | None:
    """Keep compiled executables in :func:`compilation_cache_dir`.

    Returns the directory, or None on the CPU backend, where no cache is
    set (CPU executables embed the compiling host's instruction set)."""
    if jax.default_backend() == "cpu":
        return None
    path = compilation_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
