"""Multi-head attention for the grounding transformer stack.

Batch-first ([B, S, D]), masks True = VALID. ``attention_core`` routes to
the hand-written flash-attention kernel (kernels/attention.py) when impl is
"pallas" and no weights are returned; there is no sequence-length threshold
(the JAX package's ``should_fuse`` was a TPU measurement). The weights
returning path keeps the plain softmax: the decoders' self-attention feeds
its head-averaged weights to the guided-attention loss.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels import attention as kattn
from ..ops.misc import NEG_INF


def attention_core(q, k, v, key_valid: Optional[torch.Tensor] = None,
                   return_weights: bool = False, dtype=torch.float32, impl: str = "xla"):
    """Scaled dot-product attention over heads.

    q [B, H, Lq, Dk], k [B, H, Lk, Dk], v [B, H, Lk, Dv], key_valid [B, Lk]
    bool (True = attendable). Returns (out [B, H, Lq, Dv] fp32,
    weights [B, Lq, Lk] head-averaged or None).
    """
    if not return_weights and impl == "pallas":
        b, h, lq, dk = q.shape
        lk, dv = k.shape[2], v.shape[-1]
        if key_valid is not None:
            bias = torch.where(key_valid, 0.0, -1e30).float()
        else:
            bias = torch.zeros(b, lk, dtype=torch.float32, device=q.device)
        bias = bias.repeat_interleave(h, dim=0).contiguous()  # [B*H, Lk]
        out = kattn.flash_attention(
            q.to(dtype).reshape(b * h, lq, dk).contiguous(),
            k.to(dtype).reshape(b * h, lk, dk).contiguous(),
            v.to(dtype).reshape(b * h, lk, dv).contiguous(),
            bias,
        )
        return out.reshape(b, h, lq, dv).float(), None

    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", (q.to(dtype) * scale).float(),
                          k.to(dtype).float())
    if key_valid is not None:
        logits = torch.where(key_valid[:, None, None, :], logits,
                             torch.full_like(logits, NEG_INF))
    logits = logits - logits.amax(-1, keepdim=True)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", weights.to(dtype), v.to(dtype)).float()
    if return_weights:
        return out, weights.mean(1)
    return out, None


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class Linear(nn.Linear):
    """nn.Linear computing in a given dtype (params stay fp32), like a flax
    Dense with ``dtype``: input, weight and bias are cast down, the result
    stays in that dtype."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return nn.functional.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class MultiHeadAttention(nn.Module):
    """Projected MHA in torch ``nn.MultiheadAttention``'s parameter layout
    (packed ``in_proj_weight`` [3D, D], ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 impl: str = "xla"):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.dtype, self.impl = dtype, impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Linear(d_model, d_model, dtype=dtype)

    def _proj(self, x: torch.Tensor, i: int) -> torch.Tensor:
        d, dt = self.d_model, self.dtype
        w = self.in_proj_weight[i * d:(i + 1) * d].to(dt)
        b = self.in_proj_bias[i * d:(i + 1) * d].to(dt)
        return nn.functional.linear(x.to(dt), w, b)

    def forward(self, query, key, value, key_valid=None, return_weights=False):
        h = self.num_heads
        out, weights = attention_core(
            split_heads(self._proj(query, 0), h),
            split_heads(self._proj(key, 1), h),
            split_heads(self._proj(value, 2), h),
            key_valid=key_valid, return_weights=return_weights,
            dtype=self.dtype, impl=self.impl,
        )
        return self.out_proj(merge_heads(out)), weights


class ProjectionFreeAttention(nn.Module):
    """Attention on externally projected q/k and v (q/k may be wider than v);
    only the output projection holds parameters."""

    def __init__(self, v_dim: int, num_heads: int, dtype=torch.float32, impl: str = "xla"):
        super().__init__()
        self.num_heads, self.dtype, self.impl = num_heads, dtype, impl
        self.out_proj = Linear(v_dim, v_dim, dtype=dtype)

    def forward(self, query, key, value, key_valid=None) -> torch.Tensor:
        h = self.num_heads
        out, _ = attention_core(
            split_heads(query, h), split_heads(key, h), split_heads(value, h),
            key_valid=key_valid, dtype=self.dtype, impl=self.impl,
        )
        return self.out_proj(merge_heads(out))
