"""Persistent XLA compilation cache, placed from outside.

Every window-shape bucket and PGO size is its own XLA program; a cold run
compiles them all.  The cache keeps them across processes.  Where it lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads that directory itself and
  nothing here overrides it;
* otherwise a fixed ``<repo>/.jax_cache`` (listed in ``.gitignore``), or the
  caller's ``fallback_dir``.  The path is part of what a later process
  looks up, so it never depends on the pid, the time or a temp directory.

The library sets nothing on import: entry points (``bench.py``,
``chip_smoke.py``, the CLI, ``benchmarks/profile_config5.py``) call
:func:`enable_compile_cache` once at start-up.
"""

from __future__ import annotations

import os
from typing import Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")
# Programs that compile faster than this are not worth a disk entry.
MIN_COMPILE_SECS = 0.5


def cache_dir(fallback_dir: Optional[str] = None) -> str:
    """The directory :func:`enable_compile_cache` uses (no side effects)."""
    return os.environ.get(ENV_VAR) or fallback_dir or REPO_CACHE_DIR


def enable_compile_cache(fallback_dir: Optional[str] = None) -> str:
    """Turn the persistent cache on and return its directory.
    ``fallback_dir`` applies only when ``JAX_COMPILATION_CACHE_DIR`` is
    unset."""
    import jax

    path = cache_dir(fallback_dir)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_SECS)
    return path
