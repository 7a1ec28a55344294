"""Persistent compilation cache for the entry scripts.

When `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
is configured here. Otherwise compiled programs go to a fixed `.jax_cache/`
at the repository root (listed in `.gitignore`): the cache key includes the
path, so a fixed location is what lets one run reuse another's compiles.
"""
from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
