"""On-device input preprocessing: uint8 raw frames -> normalized VideoBatch.

flip -> one bilinear resample -> ImageNet normalize -> masks, for the rgb
ingest layout. The resample reproduces ``jax.image.scale_and_translate``
with the linear kernel and ``antialias=False``: per-axis weight matrices
whose columns are renormalized over the taps that land inside the canvas
(neither ``F.interpolate`` nor ``grid_sample`` does that), applied with two
einsums.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..core.batch import RawVideoBatch, VideoBatch


def _axis_weights(in_size: int, out_size: int, scale: torch.Tensor,
                  off: torch.Tensor) -> torch.Tensor:
    """[B, in, out] linear resample weights along y_src = scale*y_out + off.

    Output index o samples input coordinate (o + 0.5)*scale + off (the
    half-pixel convention of the host transform plan).
    """
    dev = scale.device
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    # scale_and_translate with s = 1/scale, t = 0.5 - (off + 0.5)/scale,
    # in its fp32 operation order (1/s is not exactly scale)
    s = 1.0 / scale[:, None]
    t = 0.5 - (off[:, None] + 0.5) / scale[:, None]
    inv_s = 1.0 / s
    sample = (o[None] + 0.5) * inv_s - t * inv_s - 0.5               # [B, out]
    i = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = (1.0 - (sample[:, None, :] - i[None, :, None]).abs()).clamp(min=0.0)
    total = w.sum(1, keepdim=True)
    keep = total.abs() > 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(keep, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return w * inside[:, None, :]


@functools.lru_cache(maxsize=16)
def _norm_constants(mean: Tuple[float, ...], std: Tuple[float, ...],
                    device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 mean and std vectors on ``device``, made once per device and
    reused. They are filled on the device: ``torch.tensor(..., device=)``
    would be a blocking copy from pageable host memory, one host wait per
    call. Made outside inference mode, so training may use them too."""
    with torch.inference_mode(False):
        return tuple(torch.stack([torch.full((), v, dtype=torch.float32, device=device)
                                  for v in values]) for values in (mean, std))


def preprocess(raw: RawVideoBatch, mean: Tuple[float, ...],
               std: Tuple[float, ...]) -> VideoBatch:
    """RawVideoBatch (tensors) -> VideoBatch with float32 frames and masks."""
    H, W = raw.out_canvas
    f = raw.frames_u8
    b, t, hs, ws, _ = f.shape
    flip = raw.flip.bool()
    f = torch.where(flip[:, None, None, None, None], f.flip(3), f)
    f = f.float() * (1.0 / 255.0)

    scale = raw.affine_scale.float()
    off = raw.affine_off.float()
    wy = _axis_weights(hs, H, scale[:, 0], off[:, 0])   # [B, Hs, H]
    wx = _axis_weights(ws, W, scale[:, 1], off[:, 1])   # [B, Ws, W]
    f = torch.einsum("bthwc,bhy->btywc", f, wy)
    f = torch.einsum("btywc,bwx->btyxc", f, wx)

    dev = f.device
    mean_v, std_v = _norm_constants(tuple(mean), tuple(std), dev)
    f = (f - mean_v) / std_v

    rows = torch.arange(H, device=dev)[None, :] < raw.out_size[:, 0, None]
    cols = torch.arange(W, device=dev)[None, :] < raw.out_size[:, 1, None]
    pixel_valid = (rows[:, None, :, None] & cols[:, None, None, :]) \
        & raw.frame_valid.bool()[:, :, None, None]
    f = torch.where(pixel_valid[..., None], f, torch.zeros_like(f))
    return VideoBatch(
        frames=f,
        frame_valid=raw.frame_valid.bool(),
        pixel_valid=pixel_valid,
        token_ids=raw.token_ids,
        token_valid=raw.token_valid.bool(),
    )
