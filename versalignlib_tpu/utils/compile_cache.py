"""Persistent JAX compilation cache at one fixed place.

Compiling the scans and kernels takes seconds per shape; the cache keeps
them across processes. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing is set here. Otherwise the cache lives in
``.jax_cache/`` at the root of the checkout — a fixed path, because the
path is part of what makes a cache entry findable again.
"""

from __future__ import annotations

import os
import pathlib

#: default cache directory: ``<checkout>/.jax_cache`` (gitignored)
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
