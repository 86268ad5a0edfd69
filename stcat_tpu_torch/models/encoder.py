"""Cross-modal spatio-temporal encoder (factorized spatial/temporal attention).

Spatial layers attend within each frame over [frame-CLS ; HW visual ; L text]
tokens, batched over B*T frames; temporal layers attend over
[video-CLS ; per-frame CLS]; the temporal context is written back into each
valid frame's CLS slot. Parameter names follow the reference STCAT
(spatial_layers.N, temporal_layers.N, frame_cls, video_cls, local_pos_embed,
time_embed). In training mode dropout (rate ``dropout``) applies at the JAX
package's positions: the softmax weights, the attention output before its
residual add, the FFN's hidden activation and its output. Under tensor
parallelism (a layer's ``tp``) the heads and the FFN's hidden units are
split over the model group (``models/attention.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.collectives import copy_to
from ..ops.embeddings import sine_time_embedding
from ..ops.misc import dropout
from .attention import Linear, MultiHeadAttention
from .roberta import LayerNorm


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with a ReLU FFN."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, dropout: float = 0.0,
                 dtype=torch.float32, impl: str = "xla"):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout, dtype=dtype, impl=impl)
        self.linear1 = Linear(d_model, ffn_dim, dtype=dtype, init="xavier")
        self.linear2 = Linear(ffn_dim, d_model, dtype=dtype, init="xavier")
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.tp = None

    def forward(self, x, pos, valid, generator: Optional[torch.Generator] = None):
        drop = lambda h: dropout(h, self.dropout, self.training, generator)  # noqa: E731
        qk = x + pos
        attn, _ = self.self_attn(qk, qk, x, key_valid=valid, generator=generator)
        x = self.norm1(x + drop(attn))
        h = ffn_hidden(self.linear1, x, self.tp, self.dropout, self.training, generator)
        return self.norm2(x + drop(self.linear2(h)))


def ffn_hidden(linear1, x, tp, rate: float, training: bool, generator=None):
    """relu(linear1(x)) with dropout: the FFN's hidden activation, or this
    rank's part of its units under ``tp`` (x enters the model group)."""
    if tp is None:
        return dropout(torch.relu(linear1(x)), rate, training, generator)
    h = torch.relu(linear1(copy_to(x, tp.group)))
    return dropout(h, rate, training, generator, shard=(-1, tp.index, tp.parts))


class TimeEmbedding(nn.Module):
    """Sine table (default, no parameters) or learned table ``embed``."""

    def __init__(self, max_len: int, d_model: int, learned: bool = False):
        super().__init__()
        self.max_len, self.d_model, self.learned = max_len, d_model, learned
        if learned:
            self.embed = nn.Embedding(max_len, d_model)

    def forward(self, length: int, device) -> torch.Tensor:
        if self.learned:
            return self.embed.weight[:length]
        return sine_time_embedding(self.max_len, self.d_model, device)[:length]


class CrossModalEncoder(nn.Module):
    """Returns (memory [B,T,M,d], mem_valid [B,T,M], frames_cls [B,T,d],
    videos_cls [B,d]) with M = HW + L (the frame-CLS slot stripped)."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, num_layers: int,
                 max_video_len: int, learned_time_embed: bool = False,
                 dtype=torch.float32, impl: str = "xla", dropout: float = 0.0):
        super().__init__()
        layer = lambda: TransformerEncoderLayer(d_model, num_heads, ffn_dim, dropout,  # noqa: E731
                                                dtype, impl)
        self.spatial_layers = nn.ModuleList(layer() for _ in range(num_layers))
        self.temporal_layers = nn.ModuleList(layer() for _ in range(num_layers))
        self.frame_cls = nn.Embedding(1, d_model)
        self.video_cls = nn.Embedding(1, d_model)
        self.local_pos_embed = nn.Embedding(1, d_model)
        self.time_embed = TimeEmbedding(max_video_len + 1, d_model, learned_time_embed)

    def forward(self, vis_feats, vis_valid, vis_pos, text_feats, text_valid, frame_valid,
                generator: Optional[torch.Generator] = None):
        b, t, hf, wf, d = vis_feats.shape
        l, hw = text_feats.shape[1], hf * wf
        dev = vis_feats.device

        x = torch.cat([
            self.frame_cls.weight[0].expand(b, t, 1, d),
            vis_feats.reshape(b, t, hw, d),
            text_feats[:, None].expand(b, t, l, d),
        ], dim=2)                                                     # [B, T, S, d]
        pos = torch.cat([
            self.local_pos_embed.weight[0].expand(b, t, 1, d),
            vis_pos.reshape(b, t, hw, d),
            torch.zeros(b, t, l, d, dtype=vis_pos.dtype, device=dev),
        ], dim=2)
        valid = torch.cat([
            torch.ones(b, t, 1, dtype=torch.bool, device=dev),
            vis_valid.reshape(b, t, hw),
            text_valid[:, None].expand(b, t, l),
        ], dim=2)                                                     # [B, T, S]
        s = 1 + hw + l

        time_pos = self.time_embed(t + 1, dev).expand(b, t + 1, d)
        temp_valid = torch.cat(
            [torch.ones(b, 1, dtype=torch.bool, device=dev), frame_valid], dim=1
        )
        video_cls = self.video_cls.weight[0].expand(b, d)
        pos_f, valid_f = pos.reshape(b * t, s, d), valid.reshape(b * t, s)

        for spatial, temporal in zip(self.spatial_layers, self.temporal_layers):
            x = spatial(x.reshape(b * t, s, d), pos_f, valid_f, generator).reshape(b, t, s, d)
            seq = torch.cat([video_cls[:, None], x[:, :, 0]], dim=1)  # [B, T+1, d]
            seq = temporal(seq, time_pos, temp_valid, generator)
            video_cls = seq[:, 0]
            # temporal context back into each VALID frame's CLS slot
            new_cls = torch.where(frame_valid[..., None], seq[:, 1:], x[:, :, 0])
            x = torch.cat([new_cls[:, :, None], x[:, :, 1:]], dim=2)

        return x[:, :, 1:], valid[:, :, 1:], x[:, :, 0], video_cls
