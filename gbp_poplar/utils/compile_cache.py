"""JAX's persistent compilation cache, at one stable place.

A large solve compiles for tens of seconds; the cache makes a second run of
the same program shapes start at once. ``JAX_COMPILATION_CACHE_DIR`` wins
when it is set (JAX reads it itself, so nothing is set in code). Otherwise
the cache lives in ``.jax_cache/`` at the root of the checkout, listed in
``.gitignore``: a fixed path, because the path is part of every cache key.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", ".jax_cache"))


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
