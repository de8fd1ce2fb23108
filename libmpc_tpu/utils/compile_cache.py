"""Persistent compilation cache placement for the entry-point scripts.

The library itself never configures a cache; ``chip_smoke.py`` and
``bench.py`` call :func:`use_compile_cache` once at start-up.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_SUBDIR = ".jax_cache"  # listed in .gitignore


def use_compile_cache(repo_root: str) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that
    directory and nothing else is set.  Otherwise the cache lives at a fixed
    path inside the checkout, so that later runs from the same checkout hit
    it (the path is part of the cache key).
    """
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = os.path.join(os.path.abspath(repo_root), DEFAULT_SUBDIR)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program, not only those that took over a second to build
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
