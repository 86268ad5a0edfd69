"""Video frame decode on the host: an ffmpeg subprocess for video files, PIL
for a directory of JPEG frames (img_00001.jpg, ...).

The ffmpeg path decodes only the wanted frames (a trim + select filter), and
falls back to decoding the whole video and slicing, both retried. Neither
ffmpeg nor PIL is needed to import this module: each is looked up inside the
function that uses it. The native libjpeg / ffmpeg decode pools of the JAX
package are ROADMAP Queue A item 3.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List

import numpy as np


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


def load_frame_images(frame_dir: str, vid: str, frame_ids: List[int]) -> np.ndarray:
    """img_{fid:05d}.jpg frames of one video through PIL, uint8 [T, H, W, 3]."""
    from PIL import Image

    paths = [os.path.join(frame_dir, vid, f"img_{fid:05d}.jpg") for fid in frame_ids]
    return np.stack([np.asarray(Image.open(p).convert("RGB")) for p in paths])
