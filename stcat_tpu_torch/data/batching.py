"""Fixed-shape batch assembly (numpy).

``build_raw_batch`` assembles raw samples for the on-device pixel path: uint8
rgb frames, or yuv420 planes (a full-size luma plane and a half-size
interleaved CbCr plane), each with its resample plan. ``build_batch``
assembles samples whose pixels the host already transformed
(``TPU.DEVICE_PREPROCESS false``): normalised float32 frames.

The frame axis pads to a bucket from TPU.FRAME_BUCKETS, the source canvas to
64-px multiples and the output canvas to 32-px multiples (the backbone's
stride, so feature grids stay integral). Targets are frame-aligned: a clip's
GT boxes sit at the frames of its GT span, with ``box_valid`` marking them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.batch import RawVideoBatch, VideoBatch, VideoTargets

CANVAS_QUANT = 32
SRC_CANVAS_QUANT = 64


def round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def pick_bucket(t: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if t <= b:
            return b
    return round_up(t, 32)


def _pixel_key(sample: Dict) -> str:
    """The sample's pixel array: transformed float ``frames``, yuv420
    ``frames_y`` (with ``frames_cbcr``) or rgb ``frames_u8``."""
    return next(k for k in ("frames", "frames_y", "frames_u8") if k in sample)


def raw_canvases(samples: List[Dict]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(src_canvas, out_canvas) for a raw sample batch."""
    key = _pixel_key(samples[0])
    hs = max(s[key].shape[1] for s in samples)
    ws = max(s[key].shape[2] for s in samples)
    ho = max(s["plan"].out_hw[0] for s in samples)
    wo = max(s["plan"].out_hw[1] for s in samples)
    return ((round_up(hs, SRC_CANVAS_QUANT), round_up(ws, SRC_CANVAS_QUANT)),
            (round_up(ho, CANVAS_QUANT), round_up(wo, CANVAS_QUANT)))


def raw_batch_signature(samples: List[Dict], buckets: Sequence[int]) -> tuple:
    """(B, frame bucket, source canvas, output canvas, layout) of the batch
    build_raw_batch would assemble from these samples: batches with equal
    signatures have equal shapes."""
    t_bucket = pick_bucket(max(len(s["actioness"]) for s in samples), buckets)
    src_canvas, out_canvas = raw_canvases(samples)
    layout = "yuv420" if "frames_y" in samples[0] else "rgb"
    return (len(samples), t_bucket, src_canvas, out_canvas, layout)


def _build_targets(samples: List[Dict], t_bucket: int):
    """(VideoTargets of numpy arrays, frame_valid [B, T], meta list).

    An annotated sample carries ``actioness`` [T] (1 inside the GT span) and
    ``boxes_cxcywh`` [span length, 4]. A sample without ``actioness`` (a
    serving request) gets an empty-span target: no box, actioness 0 and
    temp_bound (0, -1), an inclusive span that holds no frame.
    """
    b = len(samples)
    boxes = np.zeros((b, t_bucket, 4), np.float32)
    box_valid = np.zeros((b, t_bucket), bool)
    actioness = np.zeros((b, t_bucket), np.float32)
    temp_bound = np.tile(np.asarray([0, -1], np.int32), (b, 1))
    frame_valid = np.zeros((b, t_bucket), bool)
    meta = []
    for i, s in enumerate(samples):
        t = s[_pixel_key(s)].shape[0]
        if t > t_bucket:
            raise ValueError(f"clip of {t} frames exceeds bucket {t_bucket}")
        frame_valid[i, :t] = True
        if "actioness" in s:
            act = np.asarray(s["actioness"], np.float32)
            if len(act) != t:
                raise ValueError(f"{len(act)} actioness labels for {t} frames")
            actioness[i, :t] = act
            span = np.flatnonzero(act)
            temp_bound[i] = (span[0], span[-1])
            bx = np.asarray(s["boxes_cxcywh"], np.float32)
            if len(bx) != span[-1] - span[0] + 1:
                raise ValueError(f"{len(bx)} boxes for the span {span[0]}..{span[-1]}")
            boxes[i, span[0]: span[-1] + 1] = bx
            box_valid[i, span[0]: span[-1] + 1] = True
        meta.append({
            "item_id": s.get("item_id"),
            "frame_ids": s.get("frame_ids"),
            "ori_size": s.get("ori_size"),
            "qtype": s.get("qtype", "none"),
            "duration": t,
            "pad": bool(s.get("pad", False)),
        })
    targets = VideoTargets(boxes=boxes, box_valid=box_valid, actioness=actioness,
                           temp_bound=temp_bound)
    return targets, frame_valid, meta


def build_batch(samples: List[Dict], t_bucket: int, tokenizer, max_query_len: int):
    """Host-transformed samples (frames [T,h,w,3] float32, normalised; text,
    metadata, and actioness and boxes_cxcywh when annotated) -> (VideoBatch
    of numpy arrays, VideoTargets, meta list). The frames sit at the
    top-left of a canvas of 32-px multiples, zero elsewhere, with
    ``pixel_valid`` marking them."""
    b = len(samples)
    hc = round_up(max(s["frames"].shape[1] for s in samples), CANVAS_QUANT)
    wc = round_up(max(s["frames"].shape[2] for s in samples), CANVAS_QUANT)
    frames = np.zeros((b, t_bucket, hc, wc, 3), np.float32)
    pixel_valid = np.zeros((b, t_bucket, hc, wc), bool)
    targets, frame_valid, meta = _build_targets(samples, t_bucket)
    for i, s in enumerate(samples):
        f = s["frames"]
        t, h, w, _ = f.shape
        frames[i, :t, :h, :w] = f
        pixel_valid[i, :t, :h, :w] = True
    token_ids, token_valid = tokenizer([s["text"] for s in samples], max_query_len)
    batch = VideoBatch(frames=frames, frame_valid=frame_valid, pixel_valid=pixel_valid,
                       token_ids=token_ids, token_valid=token_valid)
    return batch, targets, meta


def _place(dst: np.ndarray, f: np.ndarray, hcap: int) -> None:
    """Copy a clip's plane [t, h, w, ...] to the top-left of its canvas
    ``dst`` [T, hcap, W, ...] and replicate its boundary row and column once,
    so the resampler's edge taps clamp instead of blending into the zero
    padding."""
    t, h, w = f.shape[:3]
    dst[:t, :h, :w] = f
    if h < hcap:
        dst[:t, h, :w] = f[:, h - 1]
    if w < dst.shape[2]:
        dst[:t, : min(h + 1, hcap), w] = dst[:t, : min(h + 1, hcap), w - 1]


def build_raw_batch(samples: List[Dict], t_bucket: int, tokenizer, max_query_len: int):
    """Raw samples (rgb frames_u8 [T,h,w,3], or yuv420 frames_y [T,h,w] and
    frames_cbcr [T,ceil(h/2),ceil(w/2),2], uint8; plan, text, item_id,
    frame_ids, ori_size, pad; actioness and boxes_cxcywh when annotated) ->
    (RawVideoBatch of numpy arrays, VideoTargets of numpy arrays, meta list),
    the JAX package's return order. A chroma plane's canvas is half the
    luma canvas, its replicated row capped at that half."""
    b = len(samples)
    yuv = "frames_y" in samples[0]
    key = "frames_y" if yuv else "frames_u8"
    (hs, ws), out_canvas = raw_canvases(samples)

    if yuv:
        frames_u8 = None
        frames_y = np.zeros((b, t_bucket, hs, ws), np.uint8)
        frames_cbcr = np.zeros((b, t_bucket, hs // 2, ws // 2, 2), np.uint8)
    else:
        frames_u8 = np.zeros((b, t_bucket, hs, ws, 3), np.uint8)
        frames_y = frames_cbcr = None
    flip = np.zeros((b,), bool)
    affine_scale = np.zeros((b, 2), np.float32)
    affine_off = np.zeros((b, 2), np.float32)
    out_size = np.zeros((b, 2), np.int32)
    targets, frame_valid, meta = _build_targets(samples, t_bucket)
    for i, s in enumerate(samples):
        f, plan = s[key], s["plan"]
        t, h, w = f.shape[:3]
        if t > t_bucket or h > hs or w > ws:
            raise ValueError(f"clip {f.shape} exceeds bucket {t_bucket} / canvas {(hs, ws)}")
        if yuv:
            _place(frames_y[i], f, hs)
            _place(frames_cbcr[i], s["frames_cbcr"], hs // 2)
        else:
            _place(frames_u8[i], f, hs)
        ay, by, ax, bx = plan.affine
        if plan.flip:
            bx += ws - w  # the device flips the whole canvas
        flip[i] = plan.flip
        affine_scale[i] = (ay, ax)
        affine_off[i] = (by, bx)
        out_size[i] = plan.out_hw

    token_ids, token_valid = tokenizer([s["text"] for s in samples], max_query_len)
    batch = RawVideoBatch(
        frames_u8=frames_u8, frames_y=frames_y, frames_cbcr=frames_cbcr,
        frame_valid=frame_valid, flip=flip,
        affine_scale=affine_scale, affine_off=affine_off, out_size=out_size,
        token_ids=token_ids, token_valid=token_valid,
        out_canvas=(int(out_canvas[0]), int(out_canvas[1])),
    )
    return batch, targets, meta
