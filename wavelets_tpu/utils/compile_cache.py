"""JAX persistent compilation cache location.

One rule for every entry point (``chip_smoke.py``, ``bench.py``, the
CLI): if ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is the
cache and no other is set; otherwise the cache lives in one fixed
directory inside the checkout (``.jax_cache/``, gitignored).  The path
is part of the cache key, so it never depends on a temporary name, a
process id or the time.
"""

from __future__ import annotations

import os

import jax

__all__ = ["CACHE_ENV", "DEFAULT_CACHE_DIR", "enable_compile_cache"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"

#: ``<checkout>/.jax_cache`` — the package lives at ``<checkout>/wavelets_tpu``.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at the directory the rule
    above selects, and return it."""
    path = os.environ.get(CACHE_ENV) or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
