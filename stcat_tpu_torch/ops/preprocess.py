"""On-device input preprocessing: uint8 raw frames -> normalized VideoBatch.

flip -> one bilinear resample -> ImageNet normalize -> masks. The resample
reproduces ``jax.image.scale_and_translate`` with the linear kernel and
``antialias=False``: per-axis weight matrices whose columns are renormalized
over the taps that land inside the canvas (neither ``F.interpolate`` nor
``grid_sample`` does that), applied with two einsums.

The yuv420 layout resamples its luma plane and its half-size chroma plane to
the output grid in the same way, the chroma plane along the luma affine
rewritten into its own coordinates, and converts to RGB there (full-range
BT.601): the chroma upsample is the resample itself.
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


def _resample(f: torch.Tensor, scale: torch.Tensor, off: torch.Tensor, out_hw: Tuple[int, int]
              ) -> torch.Tensor:
    """[B, T, Hs, Ws, C] float -> [B, T, H, W, C] along the per-clip affine
    (scale, off: [B, 2] fp32, (y, x))."""
    hs, ws = f.shape[2:4]
    wy = _axis_weights(hs, out_hw[0], scale[:, 0], off[:, 0])   # [B, Hs, H]
    wx = _axis_weights(ws, out_hw[1], scale[:, 1], off[:, 1])   # [B, Ws, W]
    f = torch.einsum("bthwc,bhy->btywc", f, wy)
    return torch.einsum("btywc,bwx->btyxc", f, wx)


def _flip(f: torch.Tensor, flip: torch.Tensor, axis: int) -> torch.Tensor:
    """f flipped along ``axis`` for the clips where ``flip`` [B] is set."""
    mask = flip.view((-1,) + (1,) * (f.dim() - 1))
    return torch.where(mask, f.flip(axis), f)


def _yuv_to_rgb(y: torch.Tensor, cbcr: torch.Tensor, scale: torch.Tensor, off: torch.Tensor,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """Flipped-as-needed planes y [B, T, Hs, Ws], cbcr [B, T, Hs/2, Ws/2, 2]
    in [0, 1] -> RGB [B, T, H, W, 3] in [0, 1]. Chroma sample j sits at luma
    coordinate 2j + 0.5, so the luma line u = a*x + b is the chroma line
    (u - 0.5)/2 = (a/2)*x + (b - 0.5)/2 (fp32, the JAX order)."""
    out_y = _resample(y[..., None], scale, off, out_hw)[..., 0]
    out_c = _resample(cbcr, scale / 2.0, (off - 0.5) / 2.0, out_hw)
    # the chroma zero point is the uint8 value 128, i.e. 128/255, not 0.5
    cb = out_c[..., 0] - (128.0 / 255.0)
    cr = out_c[..., 1] - (128.0 / 255.0)
    r = out_y + 1.402 * cr
    g = out_y - 0.344136 * cb - 0.714136 * cr
    b = out_y + 1.772 * cb
    return torch.stack([r, g, b], dim=-1)


def preprocess(raw: RawVideoBatch, mean: Tuple[float, ...],
               std: Tuple[float, ...]) -> VideoBatch:
    """RawVideoBatch (tensors, rgb or yuv420) -> VideoBatch with float32
    frames and masks."""
    H, W = raw.out_canvas
    flip = raw.flip.bool()
    scale = raw.affine_scale.float()
    off = raw.affine_off.float()
    if raw.frames_y is not None:
        # each plane flips across its own width: plane position Ws/2-1-v
        # sits at luma coordinate Ws-1.5-2v, where the flipped luma's chroma
        # line lands, so the host's folded (Ws - w) offset serves both
        y = _flip(raw.frames_y, flip, 3).float() * (1.0 / 255.0)
        c = _flip(raw.frames_cbcr, flip, 3).float() * (1.0 / 255.0)
        f = _yuv_to_rgb(y, c, scale, off, (H, W))
    else:
        f = _flip(raw.frames_u8, flip, 3).float() * (1.0 / 255.0)
        f = _resample(f, scale, off, (H, W))

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
