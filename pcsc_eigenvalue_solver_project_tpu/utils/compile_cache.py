"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is the only cache directory: JAX
reads it itself and nothing here overrides it. Otherwise the cache sits at
a fixed path in the checkout, so that a second run finds what the first
compiled (the path is part of the cache key, so it must not move).
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"


def use_checkout_cache(root: str) -> str:
    """Point the compile cache at ``<root>/.jax_cache`` unless
    ``JAX_COMPILATION_CACHE_DIR`` is set; return the directory in force."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
