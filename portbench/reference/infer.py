"""The reference's input and output arithmetic: the hash tokenizer, the
evaluation resize, the bilinear resample to the model's canvas, the
normalisation, the two-stream split, the span decode, boxes in original
pixels and the merge of the two streams. A plain copy of the port's
semantics, written apart from it."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .model import NEG_INF

BOS, PAD, EOS = 0, 1, 2


def tokenize(texts: Sequence[str], max_len: int, vocab: int, offset: int = 10):
    """Whitespace words hashed by 32-bit FNV-1a into [offset, vocab), with
    <s> ... </s> and <pad>: (ids [B, L] int64, valid [B, L] bool)."""
    ids = np.full((len(texts), max_len), PAD, np.int64)
    valid = np.zeros((len(texts), max_len), bool)
    for i, text in enumerate(texts):
        row = [BOS]
        for word in text.lower().split()[: max_len - 2]:
            h = 2166136261
            for ch in word.encode():
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            row.append(offset + h % (vocab - offset))
        row.append(EOS)
        ids[i, : len(row)] = row
        valid[i, : len(row)] = True
    return ids, valid


def eval_size(h: int, w: int, size: int, max_size: int = 720) -> Tuple[int, int]:
    """The shorter side to ``size``, the longer capped at ``max_size``."""
    short, long = min(h, w), max(h, w)
    if long / short * size > max_size:
        size = int(round(max_size * short / long))
    if short == size:
        return h, w
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def round_up(x: int, q: int) -> int:
    return (x + q - 1) // q * q


def resize_frames(frames_u8: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """uint8 [T, h, w, 3] -> float [T, oh, ow, 3] in [0, 1]: a half-pixel
    bilinear resize (output o samples input (o + 0.5) h / oh - 0.5)."""
    t, h, w, _ = frames_u8.shape
    dev = frames_u8.device

    def weights(n_in, n_out):
        r = torch.tensor([n_in / n_out], device=dev)
        return _affine_weights(n_in, n_out, r, 0.5 * r - 0.5)[0]

    f = torch.einsum("thwc,hy->tywc", frames_u8.float() / 255.0, weights(h, out_hw[0]))
    return torch.einsum("tywc,wx->tyxc", f, weights(w, out_hw[1]))


def model_inputs(streams: List[Tuple[torch.Tensor, str]], bucket: int, resolution: int,
                 mean, std, max_query_len: int, vocab: int, quant: int = 32):
    """Clips (uint8 [t, h, w, 3] on the device, sentence) -> the model's
    batch: frames normalised at the evaluation size on a canvas of
    ``quant``-pixel multiples, padded to ``bucket`` frames, and the masks."""
    sizes = [eval_size(f.shape[1], f.shape[2], resolution) for f, _ in streams]
    hc = round_up(max(s[0] for s in sizes), quant)
    wc = round_up(max(s[1] for s in sizes), quant)
    dev = streams[0][0].device
    b = len(streams)
    frames = torch.zeros(b, bucket, hc, wc, 3, device=dev)
    pixel_valid = torch.zeros(b, bucket, hc, wc, dtype=torch.bool, device=dev)
    frame_valid = torch.zeros(b, bucket, dtype=torch.bool, device=dev)
    m = torch.tensor(mean, dtype=torch.float32, device=dev)
    s = torch.tensor(std, dtype=torch.float32, device=dev)
    for i, ((f, _), (oh, ow)) in enumerate(zip(streams, sizes)):
        t = f.shape[0]
        frames[i, :t, :oh, :ow] = (resize_frames(f, (oh, ow)) - m) / s
        pixel_valid[i, :t, :oh, :ow] = True
        frame_valid[i, :t] = True
    ids, valid = tokenize([text for _, text in streams], max_query_len, vocab)
    return (frames, frame_valid, pixel_valid, torch.from_numpy(ids).to(dev),
            torch.from_numpy(valid).to(dev))


def span_scores(pred_sted: torch.Tensor, frame_valid: torch.Tensor) -> torch.Tensor:
    """[B, T, T] log p(start s) + log p(end e), NEG_INF where s >= e or a
    frame is padding."""
    ls = torch.log_softmax(pred_sted[..., 0].double(), -1)
    le = torch.log_softmax(pred_sted[..., 1].double(), -1)
    score = ls[:, :, None] + le[:, None, :]
    t = pred_sted.shape[1]
    idx = torch.arange(t, device=pred_sted.device)
    ok = (idx[:, None] < idx[None, :]) & frame_valid[:, :, None] & frame_valid[:, None, :]
    return torch.where(ok, score, torch.full_like(score, NEG_INF))


def boxes_pixels(pred_boxes: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Normalised cxcywh -> xyxy in original pixels, clamped at 0."""
    cx, cy, w, h = pred_boxes.double().unbind(-1)
    xyxy = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)
    scale = torch.tensor([hw[1], hw[0], hw[1], hw[0]], dtype=torch.float64, device=xyxy.device)
    return (xyxy * scale).clamp(min=0.0)


def merged_boxes(per_stream: List[Dict[int, np.ndarray]]) -> Dict[int, np.ndarray]:
    """Frame id -> box of the union of the streams' frames, gaps filled by
    linear interpolation."""
    boxes: Dict[int, np.ndarray] = {}
    for d in per_stream:
        boxes.update(d)
    fids = sorted(boxes)
    for a, b in zip(fids[:-1], fids[1:]):
        for s in range(1, b - a):
            boxes[a + s] = boxes[a] + s * (boxes[b] - boxes[a]) / (b - a)
    return boxes


def span_gap(scores: List[np.ndarray], fids: List[List[int]], span: Sequence[int]) -> float:
    """How far below the reference's best the served span lies: the least,
    over the stream spans (s_k, e_k) whose envelope [min fid(s_k),
    max fid(e_k) + 1) is ``span``, of sum_k best_k - score_k[s_k, e_k]. The
    envelope needs one stream to start at the span's start and the others
    no earlier, and one to end at its end and the others no later."""
    start, end = int(span[0]), int(span[1]) - 1
    best_total = np.inf
    k = len(scores)
    for who_starts in range(k):
        for who_ends in range(k):
            total = 0.0
            for j, (sc, fj) in enumerate(zip(scores, fids)):
                f = np.asarray(fj)
                n = len(f)
                s_ok = (f == start) if j == who_starts else (f >= start)
                e_ok = (f == end) if j == who_ends else (f <= end)
                sub = np.where(s_ok[:, None] & e_ok[None, :], sc[:n, :n], -np.inf)
                got = sub.max()
                if not np.isfinite(got) or got <= NEG_INF / 2:
                    total = np.inf
                    break
                total += sc[:n, :n].max() - got
            best_total = min(best_total, total)
    return float(best_total)


def swap_left_right(text: str) -> str:
    """A flipped clip's sentence: 'left' and 'right' exchanged."""
    return text.replace("right", "\0").replace("left", "right").replace("\0", "left")


def decode(data_dir: str, vid: str, frame_ids: Sequence[int]) -> np.ndarray:
    """uint8 [T, h, w, 3] of the corpus's JPEG frames, decoded by PIL."""
    import os

    from PIL import Image

    return np.stack([np.asarray(Image.open(os.path.join(data_dir, "frame", vid,
                                                        f"img_{f:05d}.jpg")).convert("RGB"))
                     for f in frame_ids])


def canvas(clips: List[np.ndarray], frames: int, hs: int, ws: int) -> np.ndarray:
    """uint8 [B, frames, hs, ws, 3]: each clip at the top-left, its last row
    and column repeated once beyond it (a resample tap at the edge then
    reads the edge), zeros elsewhere."""
    out = np.zeros((len(clips), frames, hs, ws, 3), np.uint8)
    for i, f in enumerate(clips):
        t, h, w = f.shape[:3]
        out[i, :t, :h, :w] = f
        if h < hs:
            out[i, :t, h, :w] = f[:, h - 1]
        if w < ws:
            out[i, :t, : min(h + 1, hs), w] = out[i, :t, : min(h + 1, hs), w - 1]
    return out


def _affine_weights(n_in: int, n_out: int, scale: torch.Tensor, off: torch.Tensor):
    """[B, n_in, n_out] bilinear weights sampling input coordinate
    scale * o + off for output index o, renormalised over the taps."""
    o = torch.arange(n_out, dtype=torch.float64, device=scale.device)
    src = scale.double()[:, None] * o[None] + off.double()[:, None]
    i = torch.arange(n_in, dtype=torch.float64, device=scale.device)
    w = (1.0 - (src[:, None, :] - i[None, :, None]).abs()).clamp(min=0.0)
    total = w.sum(1, keepdim=True)
    w = torch.where(total > 1e-4, w / total.clamp(min=1e-12), torch.zeros_like(w))
    inside = (src >= -0.5) & (src <= n_in - 0.5)
    return (w * inside[:, None, :]).float()


def preprocess_raw(frames_u8: torch.Tensor, flip: torch.Tensor, scale: torch.Tensor,
                   off: torch.Tensor, out_canvas: Tuple[int, int], out_size: torch.Tensor,
                   frame_valid: torch.Tensor, mean, std):
    """A training clip's pixels on the model's canvas: the canvas flipped
    where ``flip``, resampled along the per-clip affine (scale, off: [B, 2],
    (y, x)), normalised, zero outside ``out_size`` and padded frames.
    Returns (frames [B, T, H, W, 3], pixel_valid [B, T, H, W])."""
    h_out, w_out = out_canvas
    f = frames_u8.float() / 255.0
    f = torch.where(flip.view(-1, 1, 1, 1, 1).bool(), f.flip(3), f)
    wy = _affine_weights(f.shape[2], h_out, scale[:, 0], off[:, 0])
    wx = _affine_weights(f.shape[3], w_out, scale[:, 1], off[:, 1])
    f = torch.einsum("bthwc,bhy->btywc", f, wy)
    f = torch.einsum("btywc,bwx->btyxc", f, wx)
    dev = f.device
    f = (f - torch.tensor(mean, device=dev)) / torch.tensor(std, device=dev)
    rows = torch.arange(h_out, device=dev)[None] < out_size[:, 0, None]
    cols = torch.arange(w_out, device=dev)[None] < out_size[:, 1, None]
    valid = (rows[:, None, :, None] & cols[:, None, None, :]) & frame_valid.bool()[:, :, None, None]
    return torch.where(valid[..., None], f, torch.zeros_like(f)), valid
