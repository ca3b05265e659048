"""Where JAX keeps its persistent compilation cache.

A cold compile of the O96 train step takes tens of seconds on a GPU, and a
cache entry is keyed by the cache path among other things, so the path has
to be the same on every run for a later run to hit.
"""

from __future__ import annotations

import os

import jax

__all__ = ["CACHE_DIR", "configure_compile_cache"]

# inside the checkout, listed in .gitignore
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".jax_cache"
)


def configure_compile_cache() -> str:
    """Point JAX's compilation cache at a fixed directory; returns it.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
    is changed here. Otherwise the cache goes to :data:`CACHE_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
