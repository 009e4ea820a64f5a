"""Where compiled programs persist between runs.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set this module
sets nothing.  Otherwise the cache lives at ``<checkout>/.jax_cache`` (a
fixed path: the path is part of the cache's key, so a moving directory
never hits; ``.gitignore`` lists it).
"""
from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
