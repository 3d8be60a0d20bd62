"""Persistent XLA compilation cache for the scripts of this repository.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other directory.  Otherwise the cache lives in one fixed
directory inside the checkout (``.jax_cache/``, listed in
``.gitignore``): the path is part of what a later run must find, so it
never moves with the working directory or the home directory.

Call :func:`enable_compile_cache` once, before the first compilation.
"""

from __future__ import annotations

import os

__all__ = ["CACHE_DIR", "enable_compile_cache"]

CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
