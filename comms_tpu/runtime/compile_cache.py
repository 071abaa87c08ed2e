"""JAX's persistent compilation cache, in one place."""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["enable_compile_cache"]

_DEFAULT = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its
    directory.  ``JAX_COMPILATION_CACHE_DIR``, when set, wins and
    nothing else is changed (JAX reads the variable itself).
    Otherwise the cache is ``<checkout>/.jax_cache``: a fixed path,
    because the path is part of what a later run must find."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(_DEFAULT))
    return str(_DEFAULT)
