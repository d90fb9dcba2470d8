"""ctypes binding for the native PNG decoder / dataset prefetcher.

The library builds at first use (`native/build.py`, g++).  Where it cannot
(no compiler, no zlib headers), `available()` is False, `decode_png` returns
None and the callers take the zlib decoder of `utils/dataset.py`; which of
the two decodes is printed by `TumSequence`, never hidden.
"""

from __future__ import annotations

import ctypes

import numpy as np

_LIB = None
_LIB_TRIED = False


BUILD_ERROR = ""      # why the library is not there, when it is not


def _load():
    global _LIB, _LIB_TRIED, BUILD_ERROR
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    from aslam_tpu_torch.native import build

    try:
        lib = ctypes.CDLL(str(build.build()))
    except (build.NativeBuildError, OSError) as e:
        BUILD_ERROR = str(e).strip().splitlines()[-1] if str(e) else repr(e)
        return None
    lib.aslam_decode_png.restype = ctypes.c_int
    lib.aslam_decode_png.argtypes = [
        ctypes.c_char_p,                  # path
        ctypes.POINTER(ctypes.c_int),     # out width
        ctypes.POINTER(ctypes.c_int),     # out height
        ctypes.POINTER(ctypes.c_int),     # out channels
        ctypes.POINTER(ctypes.c_int),     # out bit depth
        ctypes.POINTER(ctypes.c_void_p),  # out buffer (malloc'd)
    ]
    lib.aslam_free.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "aslam_prefetch_create"):
        lib.aslam_prefetch_create.restype = ctypes.c_void_p
        lib.aslam_prefetch_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.aslam_prefetch_get.restype = ctypes.c_int
        lib.aslam_prefetch_get.argtypes = (
            [ctypes.c_void_p, ctypes.c_int]
            + [ctypes.POINTER(ctypes.c_int)] * 4
            + [ctypes.POINTER(ctypes.c_void_p)]
            + [ctypes.POINTER(ctypes.c_int)] * 4
            + [ctypes.POINTER(ctypes.c_void_p)]
        )
        lib.aslam_prefetch_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def decode_png(path: str):
    """Decode a PNG via the native library.  Returns an ndarray
    (uint8 [H,W,C] / [H,W] or uint16 [H,W]) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    bits = ctypes.c_int()
    buf = ctypes.c_void_p()
    rc = lib.aslam_decode_png(
        path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
        ctypes.byref(bits), ctypes.byref(buf),
    )
    if rc != 0 or not buf.value:
        return None
    try:
        return _buf_to_array(buf, w.value, h.value, c.value, bits.value)
    finally:
        lib.aslam_free(buf)


def _buf_to_array(buf, w, h, c, bits):
    n = w * h * c
    if bits == 16:
        arr = np.ctypeslib.as_array(
            ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint16)), (n,)
        ).copy()
    else:
        arr = np.ctypeslib.as_array(
            ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), (n,)
        ).copy()
    return arr.reshape(h, w) if c == 1 else arr.reshape(h, w, c)


class NativePrefetcher:
    """Fully-native RGB-D pair prefetcher: C++ worker threads decode ahead
    of the consumer into a bounded in-order window (prefetcher.cpp).

    Decoding overlaps the device's work with no Python thread in the loop.
    `create` returns None when the shared library is not there.
    """

    @staticmethod
    def create(rgb_paths, depth_paths, lookahead: int = 4, workers: int = 2):
        lib = _load()
        if lib is None or not hasattr(lib, "aslam_prefetch_create"):
            return None
        if len(rgb_paths) != len(depth_paths) or not rgb_paths:
            return None
        return NativePrefetcher(lib, rgb_paths, depth_paths, lookahead,
                                workers)

    def __init__(self, lib, rgb_paths, depth_paths, lookahead, workers):
        self._lib = lib
        self._n = len(rgb_paths)
        rgb_blob = b"\0".join(p.encode() for p in rgb_paths) + b"\0"
        dep_blob = b"\0".join(p.encode() for p in depth_paths) + b"\0"
        self._h = lib.aslam_prefetch_create(
            rgb_blob, dep_blob, self._n, int(lookahead), int(workers))
        if not self._h:
            raise RuntimeError("aslam_prefetch_create failed")

    def __len__(self):
        return self._n

    def get(self, i: int):
        """Decoded (rgb, depth) ndarrays for frame i, or None on failure."""
        if self._h is None:
            raise RuntimeError("prefetcher closed")
        ri = [ctypes.c_int() for _ in range(4)]
        rb = ctypes.c_void_p()
        di = [ctypes.c_int() for _ in range(4)]
        db = ctypes.c_void_p()
        rc = self._lib.aslam_prefetch_get(
            self._h, int(i),
            *[ctypes.byref(x) for x in ri], ctypes.byref(rb),
            *[ctypes.byref(x) for x in di], ctypes.byref(db),
        )
        if rc != 0:
            return None
        try:
            rgb = _buf_to_array(rb, ri[0].value, ri[1].value, ri[2].value,
                                ri[3].value)
            dep = _buf_to_array(db, di[0].value, di[1].value, di[2].value,
                                di[3].value)
        finally:
            self._lib.aslam_free(rb)
            self._lib.aslam_free(db)
        return rgb, dep

    def close(self):
        if self._h is not None:
            self._lib.aslam_prefetch_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
