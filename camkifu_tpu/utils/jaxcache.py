"""Persistent JAX compilation cache setup.

A cold start compiles every jitted stage; the persistent cache lets every
later process on the same machine start warm. Called by the entry points
(ckmain, filecheck, cktrain, bench, chip_smoke) before first device use.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is the cache.
Otherwise the cache sits at one fixed path inside the checkout
(``.jax_cache``, git-ignored): the path is part of the cache key, so a
directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: <repo>/.jax_cache — fixed, independent of the working directory and HOME.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else DEFAULT_DIR."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable(path: str | None = None) -> str:
    """Point JAX's persistent cache at ``path`` (default: ``cache_dir()``)
    and cache every compile worth keeping. Returns the directory."""
    import jax

    path = path or cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
