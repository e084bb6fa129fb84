"""JAX's persistent compilation cache, configured in one place.

Every entry point (app ``main()``s, ``bench.py``, ``chip_smoke.py``,
``scripts/fullrun.py``, the test suite) calls ``enable_compile_cache``
before its first compile.
"""

from __future__ import annotations

import os

CACHE_DIR_OPTION = "jax_compilation_cache_dir"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other path is set here.  Otherwise the cache is the repository's
    fixed ``.jax_cache`` (listed in ``.gitignore``): a cache directory
    that moves between runs never hits."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update(CACHE_DIR_OPTION, path)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
