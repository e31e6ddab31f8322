"""Persistent compilation cache location for the entry points.

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
left alone. Otherwise the cache lives at ``<checkout>/.jax_cache`` (a
fixed path: the path is part of the cache key, so a moving directory
never hits). Called by ``tpurt.cli.main``, ``bench.main`` and
``chip_smoke.py`` before anything compiles.
"""

from __future__ import annotations

import os

#: ``<checkout>/.jax_cache`` (listed in .gitignore).
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
    return DEFAULT_DIR
