"""Persistent compilation cache location.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set in code.  Otherwise the cache lives at a fixed path inside the
checkout (``<checkout>/.jax_cache``, git-ignored): the path is part of the
cache key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``DEFAULT_DIR`` unless
    ``JAX_COMPILATION_CACHE_DIR`` is set (then nothing is set); returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
