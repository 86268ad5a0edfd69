"""Query decoders: DAB-style spatial decoder with iterative anchor refinement,
and the temporal (start/end) decoder.

One query per frame; the time-aligned cross-attention (query t attends to
frame t's memory only) is batched attention of [B*T, 1, *] queries against
[B*T, M, *] memories. Parameter names follow the reference STCAT
(sa_*_proj, ca_*_proj, cross_attn / cross_attn_image, norm1/3/4, ...). In
training mode dropout applies where the JAX package's decoders draw it: the
attention weights, each attention output before its residual add, the FFN's
hidden activation and its output, and after every layer of an MLP built with
a rate (the temp/action heads'). Under tensor parallelism (a layer's ``tp``)
every sa_* / ca_* pre-projection, attention input projection and linear1 is
column-parallel, so the per-head concatenation of content and sine stays on
one rank; the spatial decoder's self-attention (and the pretrained-init
cross-attention) takes the projected queries, keys and values gathered
back to full width.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.collectives import copy_to, gather
from ..ops.embeddings import anchor_sine_embedding
from ..ops.misc import dropout, inverse_sigmoid
from .attention import Linear, MultiHeadAttention, ProjectionFreeAttention, heads_of
from .encoder import ffn_hidden
from .roberta import LayerNorm


class MLP(nn.Module):
    """ReLU MLP (``layers.N``), fp32; in training mode, dropout after every
    layer (the last included, as the JAX package's MLP does)."""

    def __init__(self, din: int, hidden: int, dout: int, num_layers: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        dims = [din] + [hidden] * (num_layers - 1) + [dout]
        self.layers = nn.ModuleList(Linear(a, b, init="xavier")
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
            x = dropout(x, self.dropout, self.training, generator)
        return x


class TemplateGenerator(nn.Module):
    """anchor_logits = anchor_proj(tanh(gamma(v)) * frames_cls + tanh(beta(v)));
    content = content_proj(v), broadcast over frames (v = videos_cls)."""

    def __init__(self, d_model: int, query_dim: int = 4):
        super().__init__()
        self.content_proj = Linear(d_model, d_model, init="xavier")
        self.gamma_proj = Linear(d_model, d_model, init="xavier")
        self.beta_proj = Linear(d_model, d_model, init="xavier")
        self.anchor_proj = Linear(d_model, query_dim, init="xavier")

    def forward(self, frames_cls, videos_cls):
        gamma = torch.tanh(self.gamma_proj(videos_cls))
        beta = torch.tanh(self.beta_proj(videos_cls))
        anchor_logits = self.anchor_proj(gamma[:, None] * frames_cls + beta[:, None])
        content = self.content_proj(videos_cls)[:, None].expand(frames_cls.shape)
        return anchor_logits, content


class SpatialDecoderLayer(nn.Module):
    """Temporal self-attention + time-aligned concat cross-attention + FFN."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, dropout: float = 0.0,
                 from_scratch: bool = True, has_ca_qpos_proj: bool = True, dtype=torch.float32,
                 impl: str = "xla"):
        super().__init__()
        d = d_model
        self.d_model, self.num_heads, self.from_scratch = d, num_heads, from_scratch
        self.dropout = dropout
        for name in ("sa_qcontent_proj", "sa_qpos_proj", "sa_qtime_proj", "sa_kcontent_proj",
                     "sa_kpos_proj", "sa_ktime_proj", "sa_v_proj", "ca_qcontent_proj",
                     "ca_kcontent_proj", "ca_kpos_proj", "ca_v_proj", "ca_qpos_sine_proj"):
            self.add_module(name, Linear(d, d, init="xavier"))
        self.ca_qpos_proj = Linear(d, d, init="xavier") if has_ca_qpos_proj else None
        self.self_attn = MultiHeadAttention(d, num_heads, dropout, dtype=dtype)
        if from_scratch:
            self.cross_attn = ProjectionFreeAttention(d, num_heads, dropout, dtype=dtype,
                                                      impl=impl)
        else:
            # pretrained-init mode: a standard projected MHA (reference name)
            self.cross_attn_image = MultiHeadAttention(d, num_heads, dropout, dtype=dtype,
                                                       impl=impl)
            self.ca_qtime_proj = Linear(d, d, init="xavier")
        self.linear1 = Linear(d, ffn_dim, init="xavier")
        self.linear2 = Linear(ffn_dim, d, init="xavier")
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.norm3 = LayerNorm(d, eps=1e-5)
        self.norm4 = LayerNorm(d, eps=1e-5)
        self.tp = None

    def forward(self, tgt, memory, mem_valid, mem_pos, query_pos, query_time,
                query_sine_embed, frame_valid, generator: Optional[torch.Generator] = None):
        d, h = self.d_model, self.num_heads
        group = None if self.tp is None else self.tp.group
        enter = lambda x: copy_to(x, group)  # noqa: E731  (into the column-parallel projections)
        whole = lambda x: x if group is None else gather(x, group, -1)  # noqa: E731
        drop = lambda x: dropout(x, self.dropout, self.training, generator)  # noqa: E731
        tgt_in, time_in, pos_in = enter(tgt), enter(query_time), enter(query_pos)
        q = self.sa_qcontent_proj(tgt_in) + self.sa_qtime_proj(time_in) + self.sa_qpos_proj(pos_in)
        k = self.sa_kcontent_proj(tgt_in) + self.sa_ktime_proj(time_in) + self.sa_kpos_proj(pos_in)
        v = self.sa_v_proj(tgt_in)
        # a weights-returning call (as in stcat_tpu), so it stays on the plain path
        sa_out, _ = self.self_attn(whole(q), whole(k), whole(v), key_valid=frame_valid,
                                   return_weights=True, generator=generator)
        tgt = self.norm1(tgt + drop(sa_out))

        b, t, m, _ = memory.shape
        mem_in = enter(memory)
        q_content = self.ca_qcontent_proj(enter(tgt))
        k_content = self.ca_kcontent_proj(mem_in)
        v_mem = self.ca_v_proj(mem_in)
        k_pos = self.ca_kpos_proj(enter(mem_pos))
        if self.ca_qpos_proj is not None:  # the first layer only
            q_content = q_content + self.ca_qpos_proj(pos_in)
            k_content = k_content + k_pos
        sine = self.ca_qpos_sine_proj(enter(query_sine_embed))
        hd = d // h
        hl = heads_of(h, self.tp)  # this rank's heads
        if self.from_scratch:
            # per-head concat: [content_h ; pos_h] for q and k -> width 2 * hl * hd
            qc = torch.cat([q_content.reshape(b, t, hl, hd), sine.reshape(b, t, hl, hd)], -1)
            kc = torch.cat([k_content.reshape(b, t, m, hl, hd), k_pos.reshape(b, t, m, hl, hd)],
                           -1)
            ca_out = self.cross_attn(
                qc.reshape(b * t, 1, 2 * hl * hd), kc.reshape(b * t, m, 2 * hl * hd),
                v_mem.reshape(b * t, m, hl * hd), key_valid=mem_valid.reshape(b * t, m),
                generator=generator,
            )
        else:
            qc = whole(q_content + sine + self.ca_qtime_proj(time_in))
            kc = whole(k_content + k_pos)
            ca_out, _ = self.cross_attn_image(
                qc.reshape(b * t, 1, d), kc.reshape(b * t, m, d),
                whole(v_mem).reshape(b * t, m, d), key_valid=mem_valid.reshape(b * t, m),
                generator=generator,
            )
        # padded frames contribute nothing
        ca_out = torch.where(frame_valid[..., None], ca_out.reshape(b, t, d).float(), 0.0)
        tgt = self.norm3(tgt + drop(ca_out))
        ff = self.linear2(ffn_hidden(self.linear1, tgt, self.tp, self.dropout, self.training,
                                     generator))
        return self.norm4(tgt + drop(ff))


class SpatialDecoder(nn.Module):
    """Decoder stack with per-layer iterative anchor updates. The box head
    ``bbox_embed`` is shared with the model's final head, so it is passed in
    at call time rather than owned."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, num_layers: int,
                 query_dim: int = 4, dropout: float = 0.0, from_scratch: bool = True,
                 dtype=torch.float32, impl: str = "xla"):
        super().__init__()
        self.d_model, self.query_dim = d_model, query_dim
        self.query_scale = MLP(d_model, d_model, d_model, 2)
        # anchor_sine_embedding gives d_model // 2 features per anchor coordinate
        self.ref_point_head = MLP(query_dim * d_model // 2, d_model, d_model, 2)
        self.norm = LayerNorm(d_model, eps=1e-5)
        self.layers = nn.ModuleList(
            SpatialDecoderLayer(d_model, num_heads, ffn_dim, dropout, from_scratch,
                                has_ca_qpos_proj=(i == 0), dtype=dtype, impl=impl)
            for i in range(num_layers)
        )

    def forward(self, anchors, memory, mem_valid, mem_pos, query_time, frame_valid,
                bbox_embed: MLP, generator: Optional[torch.Generator] = None):
        d = self.d_model
        tgt = torch.zeros(anchors.shape[:2] + (d,), dtype=torch.float32, device=anchors.device)
        hs_layers, ref_layers = [], [anchors]
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            sine2d = anchor_sine_embedding(anchors, d_half=d // 2)   # [B, T, query_dim * d / 2]
            query_pos = self.ref_point_head(sine2d)
            pos_transform = 1.0 if i == 0 else self.query_scale(tgt)
            query_sine = sine2d[..., :d] * pos_transform
            tgt = layer(tgt, memory, mem_valid, mem_pos, query_pos, query_time,
                        query_sine, frame_valid, generator)
            delta = bbox_embed(tgt, generator)
            new_anchor = torch.sigmoid(delta[..., : self.query_dim] + inverse_sigmoid(anchors))
            if i != n - 1:
                ref_layers.append(new_anchor)
            anchors = new_anchor.detach()
            hs_layers.append(self.norm(tgt))
        return torch.stack(hs_layers), torch.stack(ref_layers)


class TimeDecoderLayer(nn.Module):
    """Self-attention (weights returned for the guided-attention loss) +
    time-aligned cross-attention + FFN."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, dropout: float = 0.0,
                 dtype=torch.float32, impl: str = "xla"):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout, dtype=dtype)
        self.cross_attn_image = MultiHeadAttention(d_model, num_heads, dropout, dtype=dtype,
                                                   impl=impl)
        self.linear1 = Linear(d_model, ffn_dim, init="xavier")
        self.linear2 = Linear(ffn_dim, d_model, init="xavier")
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm3 = LayerNorm(d_model, eps=1e-5)
        self.norm4 = LayerNorm(d_model, eps=1e-5)
        self.tp = None

    def forward(self, tgt, memory, mem_valid, mem_pos, query_pos, query_time_pos, frame_valid,
                generator: Optional[torch.Generator] = None):
        drop = lambda x: dropout(x, self.dropout, self.training, generator)  # noqa: E731
        qk = tgt + query_pos + query_time_pos
        sa_out, weights = self.self_attn(qk, qk, tgt, key_valid=frame_valid, return_weights=True,
                                         generator=generator)
        tgt = self.norm1(tgt + drop(sa_out))
        b, t, m, d = memory.shape
        ca_out, _ = self.cross_attn_image(
            (tgt + query_pos).reshape(b * t, 1, d), (memory + mem_pos).reshape(b * t, m, d),
            memory.reshape(b * t, m, d), key_valid=mem_valid.reshape(b * t, m),
            generator=generator,
        )
        ca_out = torch.where(frame_valid[..., None], ca_out.reshape(b, t, d).float(), 0.0)
        tgt = self.norm3(tgt + drop(ca_out))
        ff = self.linear2(ffn_hidden(self.linear1, tgt, self.tp, self.dropout, self.training,
                                     generator))
        return self.norm4(tgt + drop(ff)), weights


class TimeDecoder(nn.Module):
    """Returns per-layer normalized states [L,B,T,d] and self-attention
    weights [L,B,T,T]."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, num_layers: int,
                 dropout: float = 0.0, dtype=torch.float32, impl: str = "xla"):
        super().__init__()
        self.d_model = d_model
        self.norm = LayerNorm(d_model, eps=1e-5)
        self.layers = nn.ModuleList(
            TimeDecoderLayer(d_model, num_heads, ffn_dim, dropout, dtype, impl)
            for _ in range(num_layers)
        )

    def forward(self, memory, mem_valid, mem_pos, query_pos, query_time_pos, frame_valid,
                generator: Optional[torch.Generator] = None):
        b, t = frame_valid.shape
        tgt = torch.zeros(b, t, self.d_model, dtype=torch.float32, device=memory.device)
        states, all_weights = [], []
        for layer in self.layers:
            tgt, weights = layer(tgt, memory, mem_valid, mem_pos, query_pos, query_time_pos,
                                 frame_valid, generator)
            states.append(self.norm(tgt))
            all_weights.append(weights)
        return torch.stack(states), torch.stack(all_weights)
