"""Persistent XLA compile cache location shared by the entry points."""

from __future__ import annotations

import os

import jax

#: fixed in-checkout cache directory (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here. Otherwise the cache goes to
    ``<checkout>/.jax_cache``: a fixed path, so the next process of the
    same checkout finds what this one compiled. Returns the directory in
    use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
