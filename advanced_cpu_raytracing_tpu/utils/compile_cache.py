"""Persistent XLA compilation cache for the entry points.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it.  Otherwise the cache goes to ``<checkout>/.jax_cache``: a
fixed path, because the path is part of the cache key (a directory that
moves never hits).  git ignores it.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(CHECKOUT, ".jax_cache"))
