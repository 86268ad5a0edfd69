"""RoBERTa text encoder and the feature resizer.

Parameter names follow HuggingFace's RobertaModel (embeddings.*,
encoder.layer.N.attention.self.query, ..., pooler.dense) so the reference
STCAT state_dict lays over it. The attention is the plain torch path (the JAX
package gives RoBERTa's attention no kernel route either). LayerNorm eps is
1e-5, GELU is exact; the resizer's LayerNorm uses eps 1e-12.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .attention import Linear, attention_core, merge_heads, split_heads


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


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32 (statistics and output)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class _Embeddings(nn.Module):
    def __init__(self, c: RobertaConfig):
        super().__init__()
        self.pad_token_id = c.pad_token_id
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, token_ids: torch.Tensor, token_valid: torch.Tensor) -> torch.Tensor:
        # pad positions get pad_token_id, valid tokens count from pad_token_id + 1
        mask = token_valid.long()
        position_ids = torch.cumsum(mask, dim=1) * mask + self.pad_token_id
        x = (self.word_embeddings(token_ids.long())
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(torch.zeros_like(token_ids, dtype=torch.long)))
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, c: RobertaConfig, dtype):
        super().__init__()
        self.num_heads, self.dtype = c.num_heads, dtype
        self.query = Linear(c.hidden_size, c.hidden_size, dtype=dtype)
        self.key = Linear(c.hidden_size, c.hidden_size, dtype=dtype)
        self.value = Linear(c.hidden_size, c.hidden_size, dtype=dtype)

    def forward(self, x, token_valid):
        h = self.num_heads
        out, _ = attention_core(
            split_heads(self.query(x), h), split_heads(self.key(x), h),
            split_heads(self.value(x), h), key_valid=token_valid, dtype=self.dtype,
        )
        return merge_heads(out)


class _Output(nn.Module):
    """dense -> residual add -> LayerNorm (HF's SelfOutput / Output)."""

    def __init__(self, din: int, dout: int, eps: float, dtype):
        super().__init__()
        self.dense = Linear(din, dout, dtype=dtype)
        self.LayerNorm = LayerNorm(dout, eps=eps)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class _Attention(nn.Module):
    def __init__(self, c: RobertaConfig, dtype):
        super().__init__()
        self.self = _SelfAttention(c, dtype)
        self.output = _Output(c.hidden_size, c.hidden_size, c.layer_norm_eps, dtype)

    def forward(self, x, token_valid):
        return self.output(self.self(x, token_valid), x)


class _Intermediate(nn.Module):
    def __init__(self, c: RobertaConfig, dtype):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.intermediate_size, dtype=dtype)

    def forward(self, x):
        return F.gelu(self.dense(x), approximate="none")


class RobertaLayer(nn.Module):
    def __init__(self, c: RobertaConfig, dtype):
        super().__init__()
        self.attention = _Attention(c, dtype)
        self.intermediate = _Intermediate(c, dtype)
        self.output = _Output(c.intermediate_size, c.hidden_size, c.layer_norm_eps, dtype)

    def forward(self, x, token_valid):
        x = self.attention(x, token_valid)
        return self.output(self.intermediate(x), x)


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

    def forward(self, token_ids, token_valid):
        x = self.embeddings(token_ids, token_valid)
        for layer in self.encoder.layer:
            x = layer(x, token_valid)
        return x, self.pooler(x)


class FeatureResizer(nn.Module):
    """hidden -> d_model linear + LayerNorm(eps 1e-12)."""

    def __init__(self, din: int, dout: int, dtype=torch.float32):
        super().__init__()
        self.fc = Linear(din, dout, dtype=dtype)
        self.layer_norm = LayerNorm(dout, eps=1e-12)

    def forward(self, x):
        return self.layer_norm(self.fc(x))


class TextEncoder(nn.Module):
    """RoBERTa + resizer: (text_feats [B, L, d], text_cls [B, d]), fp32."""

    def __init__(self, d_model: int, c: RobertaConfig = RobertaConfig(), dtype=torch.float32):
        super().__init__()
        self.body = Roberta(c, dtype)
        self.resizer = FeatureResizer(c.hidden_size, d_model, dtype)

    def forward(self, token_ids, token_valid):
        hidden, pooled = self.body(token_ids, token_valid.bool())
        return self.resizer(hidden), self.resizer(pooled)
