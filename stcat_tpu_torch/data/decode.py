"""Video frame decode on the host.

A directory of JPEG frames (img_00001.jpg, ...) decodes through the native
libjpeg batch decoder (``data/jpeg_decode.py``) when the clip's size is
known and the decoder built, else through PIL. A video file decodes through
the native ffmpeg pipe pool (``data/native_decode.py``, the dataset's) or
one ffmpeg subprocess per clip: only the wanted frames (a trim + select
filter), falling back to decoding the whole video and slicing, both retried.
``DecodeRoutes`` counts which of these served each clip. Neither ffmpeg nor
PIL is needed to import this module: each is looked up inside the function
that uses it. ``rgb_to_yuv420`` converts decoded RGB for the yuv420 ingest.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

import numpy as np

from . import jpeg_decode

ROUTES = ("native", "pil", "framepool", "subprocess", "rendered")


class DecodeRoutes:
    """Clips served per decode route (thread-safe): ``native`` libjpeg,
    ``pil``, the ``framepool``, the ffmpeg ``subprocess``, or ``rendered``
    (the synthetic dataset without its JPEG corpus)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(ROUTES, 0)

    def add(self, route: str) -> None:
        with self._lock:
            self._counts[route] += 1

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


class DecodeError(RuntimeError):
    pass


def _ffmpeg() -> str:
    path = shutil.which("ffmpeg")
    if path is None:
        raise DecodeError("ffmpeg binary not available")
    return path


def _run_ffmpeg(args: List[str]) -> bytes:
    proc = subprocess.run(
        [_ffmpeg(), "-v", "error", *args, "-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, check=False,
    )
    if proc.returncode != 0:
        raise DecodeError(proc.stderr.decode()[:500])
    return proc.stdout


def decode_all_frames(path: str, h: int, w: int, retries: int = 20) -> np.ndarray:
    """Whole-video decode. Returns uint8 [N, h, w, 3]."""
    _ffmpeg()
    last = None
    for _ in range(retries):
        try:
            out = _run_ffmpeg(["-i", path])
            return np.frombuffer(out, np.uint8).reshape([-1, h, w, 3])
        except DecodeError as e:  # transient IO / container hiccups
            last = e
    raise DecodeError(f"Load Video Error: {path}: {last}")


def decode_frames(path: str, frame_ids: List[int], h: int, w: int,
                  retries: int = 20) -> np.ndarray:
    """Exactly the requested frames, uint8 [len(frame_ids), h, w, 3]."""
    _ffmpeg()
    wanted = sorted(set(int(f) for f in frame_ids))
    sel = "+".join(f"eq(n\\,{f})" for f in wanted)
    vf = f"trim=end_frame={wanted[-1] + 1},select='{sel}'"
    try:
        out = _run_ffmpeg(["-i", path, "-vf", vf, "-vsync", "0"])
        frames = np.frombuffer(out, np.uint8).reshape([-1, h, w, 3])
        if frames.shape[0] == len(wanted):
            order = {f: i for i, f in enumerate(wanted)}
            return frames[[order[int(f)] for f in frame_ids]]
    except DecodeError:
        pass
    frames = decode_all_frames(path, h, w, retries=retries)
    return frames[np.asarray(frame_ids)]


def _frame_paths(frame_dir: str, vid: str, frame_ids: List[int]) -> List[str]:
    return [os.path.join(frame_dir, vid, f"img_{fid:05d}.jpg") for fid in frame_ids]


def _pil_rgb(paths: List[str]) -> np.ndarray:
    from PIL import Image

    return np.stack([np.asarray(Image.open(p).convert("RGB")) for p in paths])


def load_frame_images(frame_dir: str, vid: str, frame_ids: List[int], hw,
                      routes: DecodeRoutes) -> np.ndarray:
    """img_{fid:05d}.jpg frames of one video, uint8 [T, H, W, 3]: the native
    decoder when it decodes them all at ``hw`` (the frames' (H, W)), else
    PIL. ``routes`` counts the route taken."""
    paths = _frame_paths(frame_dir, vid, frame_ids)
    out = jpeg_decode.decode_jpeg_batch(paths, int(hw[0]), int(hw[1]))
    if out is not None:
        routes.add("native")
        return out
    routes.add("pil")
    return _pil_rgb(paths)


def rgb_to_yuv420(frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 RGB [T, H, W, 3] -> (y [T, H, W], cbcr [T, ceil(H/2), ceil(W/2),
    2]) uint8, full-range BT.601 (the JPEG / JFIF convention of libjpeg and
    PIL). Chroma is 2x2 box-averaged with edge replication for odd sizes,
    as the native decoder subsamples. float32 arithmetic and rounding: a
    float64 conversion differs by one in the last bit on some pixels."""
    f = frames.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    t, h, w = y.shape
    if h % 2:
        cb = np.concatenate([cb, cb[:, -1:]], axis=1)
        cr = np.concatenate([cr, cr[:, -1:]], axis=1)
    if w % 2:
        cb = np.concatenate([cb, cb[:, :, -1:]], axis=2)
        cr = np.concatenate([cr, cr[:, :, -1:]], axis=2)
    hc, wc = cb.shape[1] // 2, cb.shape[2] // 2
    cb = cb.reshape(t, hc, 2, wc, 2).mean(axis=(2, 4))
    cr = cr.reshape(t, hc, 2, wc, 2).mean(axis=(2, 4))
    y_u8 = np.clip(np.rint(y), 0, 255).astype(np.uint8)
    cbcr = np.clip(np.rint(np.stack([cb, cr], axis=-1)), 0, 255).astype(np.uint8)
    return y_u8, cbcr


def load_frame_images_yuv(frame_dir: str, vid: str, frame_ids: List[int], hw,
                          routes: DecodeRoutes) -> Tuple[np.ndarray, np.ndarray]:
    """The 4:2:0 twin of ``load_frame_images``: (y [T, H, W], cbcr [T,
    ceil(H/2), ceil(W/2), 2]) uint8. The native decoder reads the codec's
    own YCbCr; through PIL the frames are decoded to RGB and converted."""
    paths = _frame_paths(frame_dir, vid, frame_ids)
    out = jpeg_decode.decode_jpeg_batch_yuv(paths, int(hw[0]), int(hw[1]))
    if out is not None:
        routes.add("native")
        return out
    routes.add("pil")
    return rgb_to_yuv420(_pil_rgb(paths))
