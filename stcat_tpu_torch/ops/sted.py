"""Temporal (start, end) training target and decoding."""

from __future__ import annotations

from typing import Optional

import torch

from .misc import NEG_INF


def gaussian_sted_target(t: int, target_idx: torch.Tensor, sigma: float,
                         time_mask: Optional[torch.Tensor] = None,
                         eps: float = 1e-6) -> torch.Tensor:
    """L1-normalized gaussian over the time axis centred at target_idx [...]
    (integer frame index); with time_mask [..., t] it is zeroed and
    renormalized over the valid frames. Returns [..., t] fp32."""
    pos = torch.arange(t, dtype=torch.float32, device=target_idx.device)
    g = torch.exp(-((pos - target_idx[..., None].float()) ** 2) / (2.0 * sigma ** 2)) + eps
    if time_mask is not None:
        g = g * time_mask.float()
    return g / g.sum(-1, keepdim=True).clamp(min=1e-12)


def decode_sted(pred_sted: torch.Tensor, time_mask: torch.Tensor):
    """Most probable (start, end) pair with start < end, both valid frames.

    score[s, e] = log_softmax(start)[s] + log_softmax(end)[e].
    pred_sted [B, T, 2] logits, time_mask [B, T] bool (True = valid).
    Returns (start_idx, end_idx), each [B] int32.
    """
    ls = torch.log_softmax(pred_sted[..., 0].float(), dim=-1)
    le = torch.log_softmax(pred_sted[..., 1].float(), dim=-1)
    score = ls[:, :, None] + le[:, None, :]
    t = pred_sted.shape[1]
    idx = torch.arange(t, device=pred_sted.device)
    valid = (idx[:, None] < idx[None, :]) & time_mask[:, :, None] & time_mask[:, None, :]
    score = torch.where(valid, score, torch.full_like(score, NEG_INF))
    flat = score.reshape(score.shape[0], -1).argmax(-1)
    return (flat // t).int(), (flat % t).int()
