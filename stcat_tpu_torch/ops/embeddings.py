"""Sinusoidal position embeddings (2-D image, 1-D time, 4-D anchor).

Channels-last, fp32, with the interleaved sin/cos order of the JAX package
(and of the STCAT reference) so converted weights line up.
"""

from __future__ import annotations

import math

import torch


def interleave_sincos(x: torch.Tensor) -> torch.Tensor:
    """out[..., 2k] = sin(x[..., 2k]); out[..., 2k+1] = cos(x[..., 2k+1])."""
    return torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()], dim=-1).flatten(-2)


def _dim_t(num_feats: int, temperature: float, device) -> torch.Tensor:
    t = torch.arange(num_feats, dtype=torch.float32, device=device)
    return temperature ** (2.0 * torch.floor(t / 2.0) / num_feats)


def sine_position_embedding_2d(
    pixel_mask: torch.Tensor,
    num_pos_feats: int = 128,
    temperature_h: float = 10000.0,
    temperature_w: float = 10000.0,
    scale: float = 2 * math.pi,
) -> torch.Tensor:
    """Normalized 2-D sine embedding of a [..., H, W] True=valid mask.

    Returns [..., H, W, 2*num_pos_feats] fp32, channel order (y, x).
    """
    not_mask = pixel_mask.float()
    y_embed = not_mask.cumsum(-2)
    x_embed = not_mask.cumsum(-1)
    eps = 1e-6
    y_embed = y_embed / (y_embed[..., -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[..., :, -1:] + eps) * scale
    dev = pixel_mask.device
    pos_x = interleave_sincos(x_embed[..., None] / _dim_t(num_pos_feats, temperature_w, dev))
    pos_y = interleave_sincos(y_embed[..., None] / _dim_t(num_pos_feats, temperature_h, dev))
    return torch.cat([pos_y, pos_x], dim=-1)


def sine_time_embedding(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """Fixed sinusoidal table [max_len, d_model]: sin at even, cos at odd channels."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model)
    )
    angles = position * div_term
    te = torch.zeros(max_len, d_model, dtype=torch.float32, device=device)
    te[:, 0::2] = torch.sin(angles)
    te[:, 1::2] = torch.cos(angles)
    return te


def anchor_sine_embedding(pos: torch.Tensor, d_half: int = 128) -> torch.Tensor:
    """Sine embedding of normalized anchors [..., 2|4] -> [..., d_half*n].

    Channel order (y, x) or (y, x, w, h).
    """
    dim_t = _dim_t(d_half, 10000.0, pos.device)

    def emb(coord):
        return interleave_sincos((coord * (2 * math.pi))[..., None] / dim_t)

    if pos.shape[-1] == 2:
        return torch.cat([emb(pos[..., 1]), emb(pos[..., 0])], dim=-1)
    if pos.shape[-1] == 4:
        return torch.cat(
            [emb(pos[..., 1]), emb(pos[..., 0]), emb(pos[..., 2]), emb(pos[..., 3])],
            dim=-1,
        )
    raise ValueError(f"anchor must have 2 or 4 coords, got {pos.shape[-1]}")
