"""Fixed-shape raw batch assembly for the on-device pixel path (numpy).

The frame axis pads to a bucket from TPU.FRAME_BUCKETS, the source canvas to
64-px multiples and the output canvas to 32-px multiples (the backbone's
stride, so feature grids stay integral).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.batch import RawVideoBatch

CANVAS_QUANT = 32
SRC_CANVAS_QUANT = 64


def round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def pick_bucket(t: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if t <= b:
            return b
    return round_up(t, 32)


def raw_canvases(samples: List[Dict]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(src_canvas, out_canvas) for a raw sample batch."""
    hs = max(s["frames_u8"].shape[1] for s in samples)
    ws = max(s["frames_u8"].shape[2] for s in samples)
    ho = max(s["plan"].out_hw[0] for s in samples)
    wo = max(s["plan"].out_hw[1] for s in samples)
    return ((round_up(hs, SRC_CANVAS_QUANT), round_up(ws, SRC_CANVAS_QUANT)),
            (round_up(ho, CANVAS_QUANT), round_up(wo, CANVAS_QUANT)))


def build_raw_batch(samples: List[Dict], t_bucket: int, tokenizer, max_query_len: int):
    """Raw samples (frames_u8 [T,h,w,3] uint8, plan, text, item_id, frame_ids,
    ori_size, pad) -> (RawVideoBatch of numpy arrays, meta list)."""
    b = len(samples)
    (hs, ws), out_canvas = raw_canvases(samples)

    frames_u8 = np.zeros((b, t_bucket, hs, ws, 3), np.uint8)
    frame_valid = np.zeros((b, t_bucket), bool)
    flip = np.zeros((b,), bool)
    affine_scale = np.zeros((b, 2), np.float32)
    affine_off = np.zeros((b, 2), np.float32)
    out_size = np.zeros((b, 2), np.int32)
    meta = []
    for i, s in enumerate(samples):
        f, plan = s["frames_u8"], s["plan"]
        t, h, w = f.shape[:3]
        if t > t_bucket or h > hs or w > ws:
            raise ValueError(f"clip {f.shape} exceeds bucket {t_bucket} / canvas {(hs, ws)}")
        dst = frames_u8[i]
        dst[:t, :h, :w] = f
        # replicate the boundary row/col once so the resampler's edge taps
        # clamp instead of blending into the zero padding
        if h < hs:
            dst[:t, h, :w] = f[:, h - 1]
        if w < ws:
            dst[:t, : min(h + 1, hs), w] = dst[:t, : min(h + 1, hs), w - 1]
        frame_valid[i, :t] = True
        ay, by, ax, bx = plan.affine
        if plan.flip:
            bx += ws - w  # the device flips the whole canvas
        flip[i] = plan.flip
        affine_scale[i] = (ay, ax)
        affine_off[i] = (by, bx)
        out_size[i] = plan.out_hw
        meta.append({
            "item_id": s.get("item_id"),
            "frame_ids": s.get("frame_ids"),
            "ori_size": s.get("ori_size"),
            "qtype": s.get("qtype", "none"),
            "duration": t,
            "pad": bool(s.get("pad", False)),
        })

    token_ids, token_valid = tokenizer([s["text"] for s in samples], max_query_len)
    batch = RawVideoBatch(
        frames_u8=frames_u8, frame_valid=frame_valid, flip=flip,
        affine_scale=affine_scale, affine_off=affine_off, out_size=out_size,
        token_ids=token_ids, token_valid=token_valid,
        out_canvas=(int(out_canvas[0]), int(out_canvas[1])),
    )
    return batch, meta
