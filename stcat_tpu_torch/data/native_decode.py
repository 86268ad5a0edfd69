"""ctypes binding of the C++ decode pipe pool (``native/framepool.cc``).

A ``FramePool`` runs shell pipelines (an ffmpeg decode of the wanted frames
to raw rgb24 on stdout) on C++ worker threads, which drain the pipe outside
the GIL while Python assembles other samples. The library is built with
g++ at first use into ``stcat_tpu_torch/_build/``
(``kernels/_build.py:NativeLibrary``). Where it cannot be built, or a decode
comes back short, the dataset decodes through one ffmpeg subprocess per clip
(``data/decode.py``) and counts that route.
"""

from __future__ import annotations

import ctypes
import shlex
from typing import List

import numpy as np

from ..kernels._build import NativeLibrary


def _declare(lib: ctypes.CDLL) -> None:
    lib.fp_create.restype = ctypes.c_void_p
    lib.fp_create.argtypes = [ctypes.c_int]
    lib.fp_submit.restype = ctypes.c_long
    lib.fp_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.fp_wait.restype = ctypes.c_long
    lib.fp_wait.argtypes = [ctypes.c_void_p, ctypes.c_long,
                            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                            ctypes.POINTER(ctypes.c_long)]
    lib.fp_release.restype = None
    lib.fp_release.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.fp_destroy.restype = None
    lib.fp_destroy.argtypes = [ctypes.c_void_p]


LIBRARY = NativeLibrary("framepool", ["-lpthread"], _declare)


def available() -> bool:
    return LIBRARY.get() is not None


class FramePool:
    """Submit shell pipelines that write raw bytes; collect them as numpy arrays."""

    def __init__(self, workers: int = 4):
        self._lib = LIBRARY.get()
        if self._lib is None:
            raise RuntimeError(f"native framepool unavailable: {LIBRARY.error}")
        self._pool = self._lib.fp_create(workers)

    def submit(self, cmd: str, max_bytes: int) -> int:
        ticket = self._lib.fp_submit(self._pool, cmd.encode(), max_bytes)
        if ticket < 0:
            raise RuntimeError("fp_submit failed")
        return ticket

    def collect(self, ticket: int) -> np.ndarray:
        """The bytes the pipeline wrote (at most its max_bytes), copied out;
        the caller checks their length (a nonzero exit that still wrote
        bytes is returned too)."""
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        size = ctypes.c_long()
        rc = self._lib.fp_wait(self._pool, ticket, ctypes.byref(ptr), ctypes.byref(size))
        try:
            if rc == -1:
                raise RuntimeError(f"unknown ticket {ticket}")
            if rc == -2:
                raise RuntimeError("decode command produced no data")
            return np.ctypeslib.as_array(ptr, shape=(size.value,)).copy()
        finally:
            self._lib.fp_release(self._pool, ticket)

    def close(self) -> None:
        if self._pool:
            self._lib.fp_destroy(self._pool)
            self._pool = None

    def __del__(self):
        # at interpreter exit the library may already be unloaded
        try:
            self.close()
        except Exception:
            pass


def ffmpeg_command(path: str, frame_ids: List[int]) -> str:
    """Shell pipeline decoding exactly frame_ids (sorted, once each) to raw
    rgb24 on stdout."""
    wanted = sorted(set(int(f) for f in frame_ids))
    sel = "+".join(f"eq(n\\,{f})" for f in wanted)
    vf = f"trim=end_frame={wanted[-1] + 1},select='{sel}'"
    return (f"ffmpeg -v error -i {shlex.quote(path)} -vf {shlex.quote(vf)} "
            f"-vsync 0 -f rawvideo -pix_fmt rgb24 pipe:")


def decode_frames_native(pool: FramePool, path: str, frame_ids: List[int], h: int, w: int
                         ) -> np.ndarray:
    """uint8 [len(frame_ids), h, w, 3] through the pool; RuntimeError when
    the pipeline wrote another number of bytes."""
    wanted = sorted(set(int(f) for f in frame_ids))
    nbytes = len(wanted) * h * w * 3
    raw = pool.collect(pool.submit(ffmpeg_command(path, frame_ids), nbytes))
    if raw.size != nbytes:
        raise RuntimeError(f"native decode got {raw.size} bytes, want {nbytes}")
    frames = raw.reshape(len(wanted), h, w, 3)
    order = {f: i for i, f in enumerate(wanted)}
    return frames[[order[int(f)] for f in frame_ids]]
