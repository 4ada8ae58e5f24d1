"""Where the persistent XLA compilation cache lives.

One rule for every entry point (the CLI, fleet servers, the benchmarks):

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and nothing is
  set here;
- otherwise, in a source checkout: ``<checkout>/.jax_cache`` (listed in
  ``.gitignore``).  The path is fixed because it is part of the cache key:
  a directory that moves between runs never hits;
- otherwise (an installed wheel): no persistent cache, JAX's default.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

_CHECKOUT = Path(__file__).resolve().parents[2]


def checkout_cache_dir() -> Optional[Path]:
    """``<checkout>/.jax_cache`` when the package runs from a source
    checkout (a ``pyproject.toml`` beside the package), else None."""
    if (_CHECKOUT / "pyproject.toml").is_file():
        return _CHECKOUT / ".jax_cache"
    return None


def enable_compile_cache() -> Optional[str]:
    """Apply the rule above before the first compile; returns the cache
    directory in use (None when there is none)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = checkout_cache_dir()
    if path is None:
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(path)
