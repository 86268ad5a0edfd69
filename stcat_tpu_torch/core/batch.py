"""Fixed-shape batch containers (plain dataclasses of tensors or arrays).

Every clip is padded to a static (T, H, W); validity masks carry the
raggedness, with True = VALID throughout (torch's ``key_padding_mask`` uses
the opposite convention and is never used here).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch


@dataclass
class VideoBatch:
    frames: Any       # [B, T, H, W, 3] normalized RGB, float
    frame_valid: Any  # [B, T] bool
    pixel_valid: Any  # [B, T, H, W] bool
    token_ids: Any    # [B, L] int
    token_valid: Any  # [B, L] bool


@dataclass
class VideoTargets:
    """Frame-aligned training targets: boxes[b, t] is frame t's GT box."""

    boxes: Any       # [B, T, 4] normalized cxcywh (zeros outside the span)
    box_valid: Any   # [B, T] bool: frame in the GT temporal span and valid
    actioness: Any   # [B, T] float {0, 1}
    temp_bound: Any  # [B, 2] int (start, end) frame index, inclusive


@dataclass
class RawVideoBatch:
    """Decoded, untransformed clips: uint8 pixels plus a per-clip resample plan.

    frames_u8[b, t] holds the clip's true pixels at the top-left of a static
    source canvas, with the boundary row/col replicated once. The affine maps
    output coords to (post-flip) source-canvas coords:
    y_src = affine_scale[b, 0] * y_out + affine_off[b, 0] (x likewise).
    out_canvas is the padded target (H, W); out_size[b] the valid region.

    The yuv420 layout (TPU.INGEST_LAYOUT "yuv420") leaves frames_u8 None and
    carries a full-size luma plane frames_y and a half-size interleaved
    chroma plane frames_cbcr instead: 1.5 bytes a pixel where rgb takes 3.
    JFIF siting puts chroma sample j at luma coordinate 2j + 0.5.
    """

    frames_u8: Any     # [B, T, Hs, Ws, 3] uint8, or None (yuv420)
    frame_valid: Any   # [B, T] bool
    flip: Any          # [B] bool
    affine_scale: Any  # [B, 2] f32 (ay, ax)
    affine_off: Any    # [B, 2] f32 (by, bx)
    out_size: Any      # [B, 2] int (h, w)
    token_ids: Any     # [B, L] int
    token_valid: Any   # [B, L] bool
    out_canvas: Tuple[int, int] = (0, 0)
    frames_y: Any = None     # [B, T, Hs, Ws] uint8 (yuv420)
    frames_cbcr: Any = None  # [B, T, Hs//2, Ws//2, 2] uint8 (yuv420)


_PER_CLIP = ("token_ids", "token_valid", "out_size", "affine_scale", "affine_off")


def subsample_stream(batch, start: int):
    """The even (start 0) or odd (start 1) frame stream of a VideoBatch or
    RawVideoBatch: every [B, T, ...] field sliced along the frame axis,
    per-clip fields and None fields kept. Works on numpy arrays and tensors."""
    t = batch.frame_valid.shape[1]
    upd = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if (getattr(v, "ndim", 0) >= 2 and v.shape[1] == t and f.name not in _PER_CLIP):
            upd[f.name] = v[:, start::2]
    return dataclasses.replace(batch, **upd)


def _stack_two(b1, b2, pad, cat):
    """b1 and b2 concatenated along the batch axis; frame-axis fields of b2
    one frame shorter than b1's (an odd T) zero-padded first. Fields that
    are not arrays (out_canvas, a None plane) must be equal and are kept."""
    t = b1.frame_valid.shape[1]
    upd = {}
    for f in dataclasses.fields(b1):
        v1, v2 = getattr(b1, f.name), getattr(b2, f.name)
        if not hasattr(v1, "ndim"):
            if v1 != v2:
                raise ValueError(f"{f.name}: the two streams differ ({v1} vs {v2})")
            continue
        if v1.ndim >= 2 and v1.shape[1] != v2.shape[1] and v2.shape[1] in (t - 1, t):
            v2 = pad(v2, t - v2.shape[1])
        upd[f.name] = cat(v1, v2)
    return dataclasses.replace(b1, **upd)


def stack_streams(b1, b2):
    """Host (numpy) stacking of the two temporal streams: one forward of
    batch 2B instead of two of B."""
    def pad(v, n):
        widths = [(0, 0)] * v.ndim
        widths[1] = (0, n)
        return np.pad(v, widths)
    return _stack_two(b1, b2, pad, lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)], 0))


def device_split_streams(batch):
    """subsample_stream(0), subsample_stream(1) and stack_streams of a batch
    already on the device, in torch: [B, T, ...] frame-axis fields become
    [2B, ceil(T/2), ...] and per-clip fields are repeated. The batch crosses
    to the device once and the split is a strided slice and a concat there."""
    def pad(v, n):
        return torch.cat([v, v.new_zeros((v.shape[0], n) + tuple(v.shape[2:]))], 1)
    return _stack_two(subsample_stream(batch, 0), subsample_stream(batch, 1), pad,
                      lambda a, b: torch.cat([a, b], 0))


def to_device(batch, device: torch.device):
    """Copy every array field of a batch container (or one bare array) to
    ``device`` as a tensor. The copies are ``non_blocking``: from pageable
    host memory the host does not wait for the card."""
    def put(v):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        return v.to(device, non_blocking=True)

    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return put(batch)
    return dataclasses.replace(batch, **{
        f.name: put(getattr(batch, f.name)) for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), (np.ndarray, torch.Tensor))})
