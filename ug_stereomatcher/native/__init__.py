"""ctypes bindings for the native host runtime (native/ug_native.cpp).

Builds lazily via make on first use; every entry point has a pure-NumPy
fallback so the framework works without a toolchain.
"""

from ug_stereomatcher.native.bindings import (
    available,
    ensure_built,
    write_pcd,
    write_ply,
    read_ppm,
    write_ppm,
    FilePrefetcher,
)

__all__ = [
    "available",
    "ensure_built",
    "write_pcd",
    "write_ply",
    "read_ppm",
    "write_ppm",
    "FilePrefetcher",
]
