"""One place that decides where compiled programs are cached.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads the variable itself and no
  code here sets another directory.
* Otherwise, on an accelerator: the fixed path ``<checkout>/.jax_cache``
  (listed in ``.gitignore``).  The path is part of each entry's key, so a
  fixed path is what lets a second process find what the first compiled.
* CPU runs stay uncached.  XLA:CPU persists ahead-of-time machine code
  whose cache key does not include the host's CPU features, so an entry
  written on one machine can be loaded on another and die with SIGILL.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir_to_set(backend: str,
                     env: Mapping[str, str] = os.environ) -> Optional[str]:
    """The directory this code should configure for ``backend``, or None
    when it should configure nothing (the variable is set, or CPU)."""
    if env.get(ENV_VAR) or backend == "cpu":
        return None
    return CHECKOUT_CACHE_DIR


def ensure_compile_cache() -> Optional[str]:
    """Enable the persistent compilation cache for this process and return
    the directory in use (None when uncached).  Idempotent."""
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    path = cache_dir_to_set(jax.default_backend())
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
