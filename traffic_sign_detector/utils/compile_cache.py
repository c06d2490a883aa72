"""Persistent XLA compilation cache for the entry points.

Every CLI, the server, the bench and ``chip_smoke.py`` call
:func:`enable_compile_cache` first, so a second run of the same shapes
loads its executables instead of recompiling them.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as is (JAX reads
    the variable itself) and nothing else is configured.  Otherwise the
    cache lives at ``<checkout>/.jax_cache`` — a fixed path, because the
    path is part of the cache key.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
