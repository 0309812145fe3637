"""Where JAX keeps its persistent compile cache.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache and nothing else is
set.  Otherwise the cache lives at ``<checkout>/.jax_cache`` — a fixed path,
because the path is part of the cache's key, and inside the checkout, which
``.gitignore`` excludes.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; return it."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
