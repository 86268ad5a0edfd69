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
    """

    frames_u8: Any     # [B, T, Hs, Ws, 3] uint8
    frame_valid: Any   # [B, T] bool
    flip: Any          # [B] bool
    affine_scale: Any  # [B, 2] f32 (ay, ax)
    affine_off: Any    # [B, 2] f32 (by, bx)
    out_size: Any      # [B, 2] int (h, w)
    token_ids: Any     # [B, L] int
    token_valid: Any   # [B, L] bool
    out_canvas: Tuple[int, int] = (0, 0)


def to_device(batch, device: torch.device):
    """Copy every array field of a batch container to ``device`` as a tensor."""
    upd = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if isinstance(v, torch.Tensor):
            upd[f.name] = v.to(device, non_blocking=True)
    return dataclasses.replace(batch, **upd)
