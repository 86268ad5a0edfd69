"""RoBERTa text encoder and the feature resizer.

Parameter names follow HuggingFace's RobertaModel (embeddings.*,
encoder.layer.N.attention.self.query, ..., pooler.dense) so the reference
STCAT state_dict lays over it. The attention is the plain torch path (the JAX
package gives RoBERTa's attention no kernel route either). LayerNorm eps is
1e-5, GELU is exact; the resizer's LayerNorm uses eps 1e-12. In training mode
dropout (``RobertaConfig.dropout``) applies where the JAX package's RoBERTa
draws it: after the embeddings' LayerNorm, on the attention weights, on the
FFN output before its residual add, and after the resizer's LayerNorm.
Under tensor parallelism (``tp``) query / key / value and intermediate.dense
are column-parallel and the two output.dense row-parallel
(``models/attention.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.collectives import copy_to
from ..ops.misc import dropout
from .attention import Linear, attention_core, heads_of, merge_heads, split_heads


@dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    dropout: float = 0.1


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32 (statistics and output)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class _Embeddings(nn.Module):
    def __init__(self, c: RobertaConfig):
        super().__init__()
        self.pad_token_id, self.dropout = c.pad_token_id, c.dropout
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, token_ids: torch.Tensor, token_valid: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # pad positions get pad_token_id, valid tokens count from pad_token_id + 1
        mask = token_valid.long()
        position_ids = torch.cumsum(mask, dim=1) * mask + self.pad_token_id
        x = (self.word_embeddings(token_ids.long())
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(torch.zeros_like(token_ids, dtype=torch.long)))
        return dropout(self.LayerNorm(x), self.dropout, self.training, generator)


class _SelfAttention(nn.Module):
    def __init__(self, c: RobertaConfig, dtype):
        super().__init__()
        self.num_heads, self.dtype, self.dropout = c.num_heads, dtype, c.dropout
        self.query = Linear(c.hidden_size, c.hidden_size, dtype=dtype)
        self.key = Linear(c.hidden_size, c.hidden_size, dtype=dtype)
        self.value = Linear(c.hidden_size, c.hidden_size, dtype=dtype)
        self.tp = None

    def forward(self, x, token_valid, generator=None):
        h = heads_of(self.num_heads, self.tp)
        x = copy_to(x, None if self.tp is None else self.tp.group)
        out, _ = attention_core(
            split_heads(self.query(x), h), split_heads(self.key(x), h),
            split_heads(self.value(x), h), key_valid=token_valid, dtype=self.dtype,
            dropout_p=self.dropout if self.training else 0.0, generator=generator, tp=self.tp,
        )
        return merge_heads(out)


class _Output(nn.Module):
    """dense -> dropout -> residual add -> LayerNorm (HF's SelfOutput /
    Output; the JAX package drops only the FFN's output, not attention's)."""

    def __init__(self, din: int, dout: int, eps: float, dtype, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.dense = Linear(din, dout, dtype=dtype)
        self.LayerNorm = LayerNorm(dout, eps=eps)

    def forward(self, h, residual, generator=None):
        h = dropout(self.dense(h), self.dropout, self.training, generator)
        return self.LayerNorm(residual + h)


class _Attention(nn.Module):
    def __init__(self, c: RobertaConfig, dtype):
        super().__init__()
        self.self = _SelfAttention(c, dtype)
        self.output = _Output(c.hidden_size, c.hidden_size, c.layer_norm_eps, dtype)

    def forward(self, x, token_valid, generator=None):
        return self.output(self.self(x, token_valid, generator), x)


class _Intermediate(nn.Module):
    def __init__(self, c: RobertaConfig, dtype):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.intermediate_size, dtype=dtype)
        self.tp = None

    def forward(self, x):
        x = copy_to(x, None if self.tp is None else self.tp.group)
        return F.gelu(self.dense(x), approximate="none")


class RobertaLayer(nn.Module):
    def __init__(self, c: RobertaConfig, dtype):
        super().__init__()
        self.attention = _Attention(c, dtype)
        self.intermediate = _Intermediate(c, dtype)
        self.output = _Output(c.intermediate_size, c.hidden_size, c.layer_norm_eps, dtype,
                              c.dropout)

    def forward(self, x, token_valid, generator=None):
        x = self.attention(x, token_valid, generator)
        return self.output(self.intermediate(x), x, generator)


class _Encoder(nn.Module):
    def __init__(self, c: RobertaConfig, dtype):
        super().__init__()
        self.layer = nn.ModuleList(RobertaLayer(c, dtype) for _ in range(c.num_layers))


class _Pooler(nn.Module):
    def __init__(self, c: RobertaConfig, dtype):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.hidden_size, dtype=dtype)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class Roberta(nn.Module):
    """Returns (last_hidden_state [B, L, H] fp32, pooled CLS [B, H])."""

    def __init__(self, c: RobertaConfig = RobertaConfig(), dtype=torch.float32):
        super().__init__()
        self.embeddings = _Embeddings(c)
        self.encoder = _Encoder(c, dtype)
        self.pooler = _Pooler(c, dtype)

    def forward(self, token_ids, token_valid, generator=None):
        x = self.embeddings(token_ids, token_valid, generator)
        for layer in self.encoder.layer:
            x = layer(x, token_valid, generator)
        return x, self.pooler(x)


class FeatureResizer(nn.Module):
    """hidden -> d_model linear + LayerNorm(eps 1e-12) + dropout."""

    def __init__(self, din: int, dout: int, dtype=torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.fc = Linear(din, dout, dtype=dtype)
        self.layer_norm = LayerNorm(dout, eps=1e-12)

    def forward(self, x, generator=None):
        return dropout(self.layer_norm(self.fc(x)), self.dropout, self.training, generator)


class TextEncoder(nn.Module):
    """RoBERTa + resizer: (text_feats [B, L, d], text_cls [B, d]), fp32.

    ``freeze_body`` (TEXT_MODEL.FREEZE) runs the RoBERTa body without
    gradients, where the JAX package cuts them with stop_gradient; the
    resizer stays trainable."""

    def __init__(self, d_model: int, c: RobertaConfig = RobertaConfig(), dtype=torch.float32,
                 freeze_body: bool = False):
        super().__init__()
        self.freeze_body = freeze_body
        self.body = Roberta(c, dtype)
        self.resizer = FeatureResizer(c.hidden_size, d_model, dtype, c.dropout)

    def forward(self, token_ids, token_valid, generator: Optional[torch.Generator] = None):
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_body):
            hidden, pooled = self.body(token_ids, token_valid.bool(), generator)
        return self.resizer(hidden, generator), self.resizer(pooled, generator)
