"""ctypes loader for libug_native.so with lazy build + NumPy fallbacks."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "libug_native.so")
_SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native")

_lib = None
_lock = threading.Lock()
_build_failed = False


def ensure_built() -> bool:
    """Build (if needed) and load the native library.  Returns success."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return True
        if _build_failed:
            return False
        # (Re)build when the library is missing OR older than its source —
        # a stale binary must never shadow edits to native/ug_native.cpp.
        # The .so itself is build output and stays out of version control.
        src = os.path.join(_SRC_DIR, "ug_native.cpp")
        stale = (not os.path.exists(_LIB_PATH)
                 or (os.path.exists(src)
                     and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)))
        if stale:
            mk = os.path.join(_SRC_DIR, "Makefile")
            if not os.path.exists(mk):
                _build_failed = not os.path.exists(_LIB_PATH)
                if _build_failed:
                    return False
            else:
                try:
                    subprocess.run(["make", "-C", _SRC_DIR, "-s"], check=True,
                                   capture_output=True, timeout=120)
                except Exception:
                    # keep serving an existing (older) library rather than
                    # failing outright; fail only if there is none at all
                    if not os.path.exists(_LIB_PATH):
                        _build_failed = True
                        return False
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return False

        lib.ug_write_pcd.restype = ctypes.c_int
        lib.ug_write_pcd.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int64]
        lib.ug_write_ply.restype = ctypes.c_int
        lib.ug_write_ply.argtypes = lib.ug_write_pcd.argtypes
        lib.ug_ppm_probe.restype = ctypes.c_int
        lib.ug_ppm_probe.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.POINTER(ctypes.c_int32)]
        lib.ug_ppm_read.restype = ctypes.c_int
        lib.ug_ppm_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                    ctypes.c_int64]
        lib.ug_ppm_write.restype = ctypes.c_int
        lib.ug_ppm_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_int32, ctypes.c_int32]
        lib.ug_prefetcher_start.restype = ctypes.c_void_p
        lib.ug_prefetcher_start.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64]
        lib.ug_prefetcher_next_size.restype = ctypes.c_int64
        lib.ug_prefetcher_next_size.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.ug_prefetcher_copy.restype = ctypes.c_int64
        lib.ug_prefetcher_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int64]
        lib.ug_prefetcher_stop.restype = None
        lib.ug_prefetcher_stop.argtypes = [ctypes.c_void_p]
        _lib = lib
        return True


def available() -> bool:
    return ensure_built()


def _prep_cloud(xyz: np.ndarray, rgb: np.ndarray):
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    assert xyz.ndim == 2 and xyz.shape[1] == 3
    assert rgb.shape == xyz.shape
    return xyz, rgb


def write_pcd(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Binary PCD writer (native fast path, NumPy fallback)."""
    xyz, rgb = _prep_cloud(xyz, rgb)
    if ensure_built():
        rc = _lib.ug_write_pcd(path.encode(), xyz.ctypes.data,
                               rgb.ctypes.data, xyz.shape[0])
        if rc == 0:
            return
    from ug_stereomatcher.geom.pointcloud import PointCloud, save_pcd
    save_pcd(path, PointCloud(xyz=xyz, rgb=rgb))


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    xyz, rgb = _prep_cloud(xyz, rgb)
    if ensure_built():
        rc = _lib.ug_write_ply(path.encode(), xyz.ctypes.data,
                               rgb.ctypes.data, xyz.shape[0])
        if rc == 0:
            return
    from ug_stereomatcher.geom.pointcloud import PointCloud, save_ply
    save_ply(path, PointCloud(xyz=xyz, rgb=rgb))


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM as (H, W, 3) uint8."""
    if ensure_built():
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        if _lib.ug_ppm_probe(path.encode(), ctypes.byref(w),
                             ctypes.byref(h)) == 0:
            out = np.empty((h.value, w.value, 3), dtype=np.uint8)
            if _lib.ug_ppm_read(path.encode(), out.ctypes.data,
                                out.nbytes) == 0:
                return out
    # fallback: tiny pure-python P6 parser
    with open(path, "rb") as fh:
        magic = fh.readline().split()
        if not magic or magic[0] != b"P6":
            raise ValueError(f"{path}: not a binary P6 PPM file")
        def tokens(line: bytes) -> List[int]:
            # a '#' starts a comment running to end of line — it may share
            # the line with dimension tokens ("640 480 # scanner output")
            return [int(v) for v in line.split(b"#", 1)[0].split()]

        vals: List[int] = tokens(b" ".join(magic[1:]))
        while len(vals) < 3:
            line = fh.readline()
            if not line:
                raise ValueError(f"{path}: truncated PPM header")
            vals += tokens(line)
        w_, h_, maxv = vals[0], vals[1], vals[2]
        if maxv != 255:
            raise ValueError(f"{path}: only maxval 255 PPMs supported")
        data = fh.read(w_ * h_ * 3)
    return np.frombuffer(data, dtype=np.uint8).reshape(h_, w_, 3)


def write_ppm(path: str, image: np.ndarray) -> None:
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        # the native writer fwrites w*h*3 bytes straight from this buffer
        # — anything but (H, W, 3) would over-read or scramble channels
        raise ValueError(
            f"write_ppm needs an (H, W, 3) uint8 image, got {image.shape}")
    h, w = image.shape[:2]
    if ensure_built():
        if _lib.ug_ppm_write(path.encode(), image.ctypes.data, w, h) == 0:
            return
    with open(path, "wb") as fh:
        fh.write(b"P6\n%d %d\n255\n" % (w, h))
        fh.write(image.tobytes())


class FilePrefetcher:
    """Background-thread raw-file prefetcher (native ring buffer).

    Replaces the reference's capture-process + TCPROS hop with an in-process
    pipeline that overlaps disk IO with device compute.  Falls back to a
    Python thread if the native library is unavailable."""

    def __init__(self, paths: List[str], capacity: int = 2):
        self.paths = list(paths)
        self._native = ensure_built()
        if self._native:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._handle = _lib.ug_prefetcher_start(arr, len(self.paths),
                                                    capacity)
            self._arr = arr  # keep alive
        else:
            import queue
            import threading as th
            self._q: "queue.Queue" = queue.Queue(maxsize=capacity)

            def run():
                for i, p in enumerate(self.paths):
                    try:
                        with open(p, "rb") as fh:
                            self._q.put((i, fh.read()))
                    except OSError:
                        self._q.put((i, b""))
                self._q.put(None)

            self._thread = th.Thread(target=run, daemon=True)
            self._thread.start()

    def __iter__(self):
        if self._native:
            while True:
                idx = ctypes.c_int64()
                size = _lib.ug_prefetcher_next_size(self._handle,
                                                    ctypes.byref(idx))
                if size < 0:
                    return
                buf = np.empty(size, dtype=np.uint8)
                got = _lib.ug_prefetcher_copy(self._handle, buf.ctypes.data,
                                              size)
                if got < 0:
                    return
                yield int(idx.value), buf.tobytes()
        else:
            while True:
                item = self._q.get()
                if item is None:
                    return
                yield item

    def close(self):
        if self._native and self._handle:
            _lib.ug_prefetcher_stop(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
