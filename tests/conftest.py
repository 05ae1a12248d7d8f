"""Test configuration: run everything on a virtual 8-device CPU mesh.

This mirrors the strategy described in SURVEY.md §4: multi-device sharding is
validated on CPU via --xla_force_host_platform_device_count without needing
several cards.  The config is pinned back to CPU before any backend is
initialised (backend init is lazy, so this works even when jax was already
imported at interpreter start).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

# Compile-cache isolation: the suite must NOT share a persistent compilation
# cache.  One can hold XLA:CPU AOT executables compiled on a different host
# (different machine features => different FMA contraction => order-dependent
# numerics in bit-exactness gates, and a real SIGILL risk).  The cache helper
# (compile_cache.py) leaves CPU runs uncached unless JAX_COMPILATION_CACHE_DIR
# is set, so drop that variable and any configured directory.
os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", None)
