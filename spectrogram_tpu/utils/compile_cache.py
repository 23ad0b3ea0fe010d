"""JAX persistent compilation cache at one fixed place.

The cache key includes the cache directory, so a directory that moves
between runs never hits.  Entry points (the CLI, `bench.py`,
`chip_smoke.py`, `examples/`) call `enable_compile_cache()` once before
their first compile.
"""

from __future__ import annotations

import os
import pathlib

import jax

# `.jax_cache/` at the root of the checkout (gitignored).
CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and this
    sets nothing; otherwise the cache goes to `CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
