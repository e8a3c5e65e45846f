"""Where JAX keeps its persistent compile cache.

A 1920x1152 encode compiles for tens of seconds; the persistent cache lets a
second process on the same machine skip that.  The cache key includes its
path, so the path is fixed: ``JAX_COMPILATION_CACHE_DIR`` when it is set
(JAX reads it itself, and nothing here overrides it), otherwise ``.jax_cache``
at the root of the checkout (listed in ``.gitignore``).
"""
from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Point the persistent compile cache at its directory and return it.

    Call before the process first compiles anything."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
