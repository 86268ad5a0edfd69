"""Temporal (start, end) decoding."""

from __future__ import annotations

import torch

from .misc import NEG_INF


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
