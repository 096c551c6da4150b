"""Placement of JAX's persistent compilation cache.

The one place the program chooses the cache directory. Scripts call
`enable_compile_cache()` once, before their first compile."""

from __future__ import annotations

import os
import pathlib

REPO_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> pathlib.Path:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<repo>/.jax_cache`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return pathlib.Path(env) if env else REPO_CACHE


def enable_compile_cache() -> pathlib.Path:
    """Point JAX's persistent compilation cache at `cache_dir()` and
    return it. The path is part of the cache key, so it is fixed."""
    import jax

    path = cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    return path
