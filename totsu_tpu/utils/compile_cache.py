"""Persistent XLA compilation cache for the repository's scripts.

Importing the library sets no cache. Scripts that compile large solves
(``chip_smoke.py``, ``bench.py``, ``benchmarks/*.py``) call
:func:`enable_compile_cache` once, before their first compilation.
"""

import os

#: the repository root: the directory that holds the ``totsu_tpu`` package
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it at start-up
    and nothing is changed here. Otherwise the cache goes to
    ``<repo>/.jax_cache`` (listed in ``.gitignore``): a fixed path, because
    the path is part of the cache's key and a moving directory never hits.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
