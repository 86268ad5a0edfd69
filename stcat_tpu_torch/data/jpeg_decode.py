"""ctypes binding of the native JPEG batch decoder (``native/jpegpool.cc``).

Decodes a clip's frame files straight into one preallocated uint8 array with
the system libjpeg, on a few C++ threads outside the GIL. The library is
built with g++ at first use into ``stcat_tpu_torch/_build/``
(``kernels/_build.py:NativeLibrary``); where it cannot be built, or a file
does not decode to the expected size, the functions return None and the
caller (``data/decode.py``) decodes through PIL instead and counts that
route.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ..kernels._build import NativeLibrary

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _declare(lib: ctypes.CDLL) -> None:
    lib.jp_decode_batch.restype = ctypes.c_long
    lib.jp_decode_batch.argtypes = [ctypes.c_char_p, ctypes.c_long, _U8P,
                                    ctypes.c_long, ctypes.c_long, ctypes.c_long]
    lib.jp_decode_batch_yuv.restype = ctypes.c_long
    lib.jp_decode_batch_yuv.argtypes = [ctypes.c_char_p, ctypes.c_long, _U8P, _U8P,
                                        ctypes.c_long, ctypes.c_long, ctypes.c_long]


LIBRARY = NativeLibrary("jpegpool", ["-ljpeg", "-lpthread"], _declare)


def available() -> bool:
    return LIBRARY.get() is not None


def _blob(paths: List[str]) -> bytes:
    return b"".join(p.encode() + b"\0" for p in paths)


def decode_jpeg_batch(paths: List[str], h: int, w: int, workers: int = 2
                      ) -> Optional[np.ndarray]:
    """uint8 [len(paths), h, w, 3] RGB, or None when the native path cannot
    decode them (no library, an unreadable file, another size)."""
    lib = LIBRARY.get()
    if lib is None:
        return None
    out = np.empty((len(paths), h, w, 3), np.uint8)
    failures = lib.jp_decode_batch(_blob(paths), len(paths), out.ctypes.data_as(_U8P),
                                   h, w, workers)
    return None if failures else out


def decode_jpeg_batch_yuv(paths: List[str], h: int, w: int, workers: int = 2
                          ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """4:2:0 planes as the codec stores them: (y [n, h, w], cbcr [n,
    ceil(h/2), ceil(w/2), 2]) uint8, chroma 2x2 box-averaged; or None, as
    ``decode_jpeg_batch``."""
    lib = LIBRARY.get()
    if lib is None:
        return None
    n = len(paths)
    y = np.empty((n, h, w), np.uint8)
    cbcr = np.empty((n, (h + 1) // 2, (w + 1) // 2, 2), np.uint8)
    failures = lib.jp_decode_batch_yuv(_blob(paths), n, y.ctypes.data_as(_U8P),
                                       cbcr.ctypes.data_as(_U8P), h, w, workers)
    return None if failures else (y, cbcr)
