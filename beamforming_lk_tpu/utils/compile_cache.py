"""Persistent XLA compilation cache at a fixed place.

Entry points (the CLI, ``chip_smoke.py``, ``bench.py`` and
``benchmarks/*.py``) call :func:`use_compile_cache` before their first
compilation, so repeated runs of one checkout reuse compiled programs.
Importing the package sets nothing.
"""

from __future__ import annotations

import os
import pathlib

#: ``<checkout>/.jax_cache`` — a fixed path, since the directory is part of
#: the cache's key: a name that changes per run would never hit.
CHECKOUT_CACHE_DIR = str(
    pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"
)


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``<checkout>/.jax_cache``
    unless ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads that
    variable itself and this sets nothing).  Returns the directory in
    effect."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
