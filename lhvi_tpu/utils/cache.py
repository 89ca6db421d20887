"""Where compiled XLA programs are kept between processes."""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and
    nothing is set here. Otherwise the cache lives in ``<repo>/.jax_cache``
    (listed in ``.gitignore``), a fixed path so that later processes hit.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
