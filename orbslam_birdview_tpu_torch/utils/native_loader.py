"""ctypes wrapper for the native prefetching image loader (native/).

Decodes PNG/JPEG/PGM to grayscale float32 on a C++ worker pool with a
bounded ring buffer; falls back to synchronous decoding through
`utils/imageio.py` when the shared library is not built. Build with
`make -C native`.

The library's PNG path differs from OpenCV's on colour PNGs read as gray
(libpng's default Rec. 709 weights) and on 16-bit PNGs (stripped to their
high byte); its JPEG and 8-bit gray PNG paths match. The dataset loaders
decode through `utils/imageio.py`, never through this library.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Iterator

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libslamio.so"
_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None      # built for another system (libpng / libjpeg absent)
    lib.slam_loader_create.restype = ctypes.c_void_p
    lib.slam_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.slam_loader_next.restype = ctypes.c_int
    lib.slam_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.slam_loader_destroy.restype = None
    lib.slam_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


class PrefetchLoader:
    """Iterate grayscale float32 frames decoded ahead of time on C++
    threads. Order is preserved."""

    def __init__(self, paths, n_threads: int = 3, queue_cap: int = 8,
                 max_pixels: int = 4096 * 4096):
        self.paths = [str(p) for p in paths]
        self.max_pixels = max_pixels
        lib = _load_lib()
        self._lib = lib
        self._handle = None
        if lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._handle = lib.slam_loader_create(
                arr, len(self.paths), n_threads, queue_cap)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._handle is None:
            from . import imageio

            for p in self.paths:
                try:
                    img = imageio.imread(p, imageio.IMREAD_GRAYSCALE)
                except (OSError, ValueError) as e:
                    raise IOError(f"decode failed: {p}") from e
                yield img.astype(np.float32)
            return
        lib = self._lib
        buf = np.empty(self.max_pixels, np.float32)
        w = ctypes.c_int()
        h = ctypes.c_int()
        while True:
            rc = lib.slam_loader_next(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.max_pixels, ctypes.byref(w), ctypes.byref(h))
            if rc == -1:
                return
            if rc < 0:
                raise IOError(f"native loader error {rc}")
            yield buf[: w.value * h.value].reshape(h.value, w.value).copy()

    def close(self):
        if self._handle is not None:
            self._lib.slam_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
