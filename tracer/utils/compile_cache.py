"""Where JAX keeps its persistent compilation cache.

The cache key includes the directory, so the directory must not move
between runs: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads the
variable itself), otherwise `.jax_cache` at the root of the checkout.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def cache_dir() -> str:
    """The directory the cache uses (nothing is created or configured)."""
    return os.environ.get(ENV_VAR) or str(CHECKOUT / ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()`.

    Call before the first compile. With the environment variable set,
    nothing is changed. Returns the directory.
    """
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
