"""Multi-head attention for the grounding transformer stack.

Batch-first ([B, S, D]), masks True = VALID. ``attention_core`` routes to
the hand-written flash-attention kernels (kernels/attention.py: K1 forward,
K2 backward) when impl is "pallas", no weights are returned and no dropout
is drawn, as the JAX package's ``attention_core`` does; there is no
sequence-length threshold (the JAX package's ``should_fuse`` was a TPU
measurement). Otherwise the plain softmax runs: the decoders'
self-attention returns its head-averaged weights for the guided-attention
loss, and a training call with attention dropout drops softmax weights
(torch ``nn.MultiheadAttention`` semantics), which the kernels do not do.

Tensor parallelism (``models.parallelize``): a module whose ``tp`` is a
``core.mesh.Shard`` holds its heads' part of every input projection
(column-parallel) and runs ``num_heads / parts`` heads; its inputs enter the
group through ``collectives.copy_to`` and a row-parallel ``Linear``
(``row_parallel`` set) sums its partial products over the group. Returned
attention weights are averaged over every head of the group.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.collectives import copy_to, reduce_from
from ..kernels import attention as kattn
from ..ops.misc import NEG_INF, dropout


def attention_core(q, k, v, key_valid: Optional[torch.Tensor] = None,
                   return_weights: bool = False, dtype=torch.float32, impl: str = "xla",
                   dropout_p: float = 0.0, generator: Optional[torch.Generator] = None,
                   tp=None):
    """Scaled dot-product attention over heads.

    q [B, H, Lq, Dk], k [B, H, Lk, Dk], v [B, H, Lk, Dv], key_valid [B, Lk]
    bool (True = attendable). ``dropout_p`` > 0 drops softmax weights with a
    keep mask from ``generator`` (callers pass 0 outside training); with
    ``tp`` (a Shard: these are its part of the heads) the mask is that
    part of the whole heads' mask. Returns (out [B, H, Lq, Dv] fp32, weights
    [B, Lq, Lk] averaged over these heads, or None).
    """
    if not return_weights and dropout_p <= 0.0 and impl == "pallas":
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
    logits = logits - logits.amax(-1, keepdim=True).detach()
    weights = torch.softmax(logits, dim=-1)
    pv_weights = dropout(weights, dropout_p, True, generator,
                         shard=None if tp is None else (1, tp.index, tp.parts))
    out = torch.einsum("bhqk,bhkd->bhqd", pv_weights.to(dtype), v.to(dtype)).float()
    if return_weights:
        return out, weights.mean(1)
    return out, None


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def heads_of(num_heads: int, tp) -> int:
    """The heads this rank runs: all of them, or its part under ``tp``."""
    return num_heads if tp is None else num_heads // tp.parts


class _PartialProduct(torch.autograd.Function):
    """x @ w.T of compute-dtype operands, its fp32 sum left unrounded: on a
    card one tensor-core GEMM with an fp32 result (``torch.mm``'s
    ``out_dtype``), on the CPU the same products (exact in fp32) summed in
    fp32. The backward takes compute-dtype GEMMs, as an unsharded Linear's
    does: the gradient arriving here is the compute-dtype gradient of the
    rounded output, so casting it back down is exact."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.dtype == torch.float32:
            out = x2 @ w.t()
        elif x.is_cuda:
            out = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            out = x2.float() @ w.float().t()
        return out.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        gx = g @ w if ctx.needs_input_grad[0] else None
        gw = (g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw


# std of the unit normal truncated to [-2, 2]: flax's truncated-normal
# initialisers divide by it to keep the std they are asked for
TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: the unit normal truncated to [-2, 2], scaled
    to std 1 / sqrt(fan_in)."""
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.mul_(1.0 / (TRUNCATED_STD * math.sqrt(fan_in)))


def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``xavier_uniform`` of a [out, in] weight: uniform on
    +-sqrt(6 / (fan_in + fan_out))."""
    bound = math.sqrt(6.0 / sum(t.shape))
    t.uniform_(-bound, bound, generator=generator)


class Linear(nn.Linear):
    """nn.Linear computing in a given dtype (params stay fp32), like a flax
    Dense with ``dtype``: input, weight and bias are cast down, the result
    stays in that dtype.

    Row-parallel (``row_parallel`` a Shard): the weight holds this rank's
    input columns, x its part of the input. The partial product of the
    compute-dtype operands is one GEMM with an fp32 result
    (``_PartialProduct``), summed over the group, the (replicated) bias
    added and the result rounded once, as one process's GEMM rounds its
    fp32 sum once.

    ``init`` names the distribution of a fresh weight, read by
    ``models.init_parameters``: "lecun" (flax's default kernel init) or
    "xavier" (where the JAX package passes ``kernel_init=xavier_uniform``)."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32,
                 init: str = "lecun"):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        self.init = init
        self.row_parallel = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.row_parallel is None:
            return nn.functional.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
        partial = _PartialProduct.apply(x.to(dt), self.weight.to(dt))
        return (reduce_from(partial, self.row_parallel.group) + self.bias.to(dt).float()).to(dt)


class MultiHeadAttention(nn.Module):
    """Projected MHA in torch ``nn.MultiheadAttention``'s parameter layout
    (packed ``in_proj_weight`` [3D, D], ``in_proj_bias``, ``out_proj``);
    ``dropout`` applies to the softmax weights in training mode."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 dtype=torch.float32, impl: str = "xla"):
        super().__init__()
        self.d_model, self.num_heads, self.dropout = d_model, num_heads, dropout
        self.dtype, self.impl = dtype, impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Linear(d_model, d_model, dtype=dtype)
        self.tp = None

    def _proj(self, x: torch.Tensor, i: int) -> torch.Tensor:
        dt = self.dtype
        w = self.in_proj_weight.chunk(3)[i].to(dt)
        b = self.in_proj_bias.chunk(3)[i].to(dt)
        return nn.functional.linear(x.to(dt), w, b)

    def forward(self, query, key, value, key_valid=None, return_weights=False,
                generator: Optional[torch.Generator] = None):
        group = None if self.tp is None else self.tp.group
        q_in = copy_to(query, group)
        k_in = q_in if key is query else copy_to(key, group)
        v_in = q_in if value is query else k_in if value is key else copy_to(value, group)
        h = heads_of(self.num_heads, self.tp)
        out, weights = attention_core(
            split_heads(self._proj(q_in, 0), h),
            split_heads(self._proj(k_in, 1), h),
            split_heads(self._proj(v_in, 2), h),
            key_valid=key_valid, return_weights=return_weights,
            dtype=self.dtype, impl=self.impl,
            dropout_p=self.dropout if self.training else 0.0, generator=generator, tp=self.tp,
        )
        if weights is not None and self.tp is not None:  # the mean over every head
            weights = reduce_from(weights * h, group) / self.num_heads
        return self.out_proj(merge_heads(out)), weights


class ProjectionFreeAttention(nn.Module):
    """Attention on externally projected q/k and v (q/k may be wider than v);
    only the output projection holds parameters."""

    def __init__(self, v_dim: int, num_heads: int, dropout: float = 0.0,
                 dtype=torch.float32, impl: str = "xla"):
        super().__init__()
        self.num_heads, self.dropout, self.dtype, self.impl = num_heads, dropout, dtype, impl
        self.out_proj = Linear(v_dim, v_dim, dtype=dtype)
        self.tp = None

    def forward(self, query, key, value, key_valid=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = heads_of(self.num_heads, self.tp)
        out, _ = attention_core(
            split_heads(query, h), split_heads(key, h), split_heads(value, h),
            key_valid=key_valid, dtype=self.dtype, impl=self.impl,
            dropout_p=self.dropout if self.training else 0.0, generator=generator, tp=self.tp,
        )
        return self.out_proj(merge_heads(out))
