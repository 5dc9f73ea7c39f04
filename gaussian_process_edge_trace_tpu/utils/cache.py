"""JAX's persistent compilation cache, configured in one place.

A whole trace compiles to one large XLA program, and its first call is
mostly compilation; the cache turns later cold starts into a load.
"""

from __future__ import annotations

import os

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compilation_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is set here. Otherwise the cache goes to
    ``<checkout>/.jax_cache``.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
