"""JAX persistent compilation cache location.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX already uses it and nothing is
changed.  Otherwise the cache goes to a fixed directory inside the checkout,
`<checkout>/.jax_cache/` (listed in .gitignore): a fixed path, because the
path is part of the cache key.
"""

from __future__ import annotations

import os
from pathlib import Path

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"
_done = False


def init_compile_cache() -> None:
    """Point JAX's persistent cache at its directory; call before compiling."""
    global _done
    if _done:
        return
    _done = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
