"""The plain reference of STCAT: ResNet-101 with frozen batch norm, RoBERTa,
the cross-modal encoder and the two query decoders, in plain torch.

A frozen copy of the port's model code on its plain routes, with the same
parameter names (the reference STCAT state_dict), so one state_dict loads
into both. It keeps nothing of the port's kernels, tensor parallelism or
mixed precision: every product runs through ``Ops``, which is float32
(``FP32``, the reference) or float8 (``FP8``, the control: the next
precision below the bfloat16 the recipes state). Dropout draws every keep mask from the generator handed to
``forward`` with ``torch.rand(x.shape)``, in the port's order, so the same
generator seed replays the port's masks. Imports neither the port nor JAX.

``MODEL.VISION_BACKBONE.DILATION`` (DC5) follows torchvision's
``replace_stride_with_dilation = [False, False, True]``: layer4 keeps
stride 1, its first block's 3x3 keeps the dilation before it (1) beside a
stride-1 projection, and every later layer4 3x3 has dilation 2 and padding
2. The port's ``ResNet`` puts dilation 2 on layer4.0's 3x3 too; this
reference does not follow it there.

``arch_of`` refuses, before any set-up, a configuration that sets a key the
port's model or the training loss reads to a value this reference does not
model (``ONLY``); ``MODELLED`` names the keys it follows and ``INERT`` those
that change neither the forward nor the loss.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

NEG_INF = -1e32
BN_EPS = 1e-5


class Ops:
    """Products in float32: ``quantize`` rounds each operand and ``store``
    each result (the identity here)."""

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def store(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def linear(self, x, w, b=None):
        return self.store(F.linear(self.quantize(x), self.quantize(w), b))

    def conv(self, x, w, stride=1, padding=0, dilation=1):
        return self.store(F.conv2d(self.quantize(x), self.quantize(w), None, stride, padding,
                                   dilation))

    def einsum(self, eq, a, b):
        return self.store(torch.einsum(eq, self.quantize(a), self.quantize(b)))


def _to_float8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 format with a per-tensor scale (its largest
    magnitude at the format's largest finite value ``top``)."""
    scale = x.abs().amax().float().clamp(min=1e-30) / top
    return ((x / scale).to(dtype).float() * scale).to(x.dtype)


class _Float8Store(torch.autograd.Function):
    """A product's result held in float8 e4m3, its gradient in e5m2 (the
    two formats of float8 training)."""

    @staticmethod
    def forward(ctx, x):
        return _to_float8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _to_float8(g, torch.float8_e5m2, 57344.0)


class Float8Ops(Ops):
    """float8 where the port computes in bfloat16: each product's operands
    and result in e4m3 with a per-tensor scale, accumulated in float32, the
    gradient arriving at a result in e5m2; the operands' rounding passes
    gradients straight through."""

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        return x + (_to_float8(x.detach(), torch.float8_e4m3fn, 448.0) - x).detach()

    def store(self, x: torch.Tensor) -> torch.Tensor:
        return _Float8Store.apply(x)


FP32, FP8 = Ops(), Float8Ops()


def dropout(x, p: float, training: bool, generator):
    if not training or p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), x.new_zeros(()))


def inverse_sigmoid(x, eps: float = 1e-3):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def interleave_sincos(x):
    return torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()], dim=-1).flatten(-2)


def _dim_t(n: int, temperature: float, device):
    t = torch.arange(n, dtype=torch.float32, device=device)
    return temperature ** (2.0 * torch.floor(t / 2.0) / n)


def sine_position_2d(mask, n: int):
    m = mask.float()
    y, x = m.cumsum(-2), m.cumsum(-1)
    y = y / (y[..., -1:, :] + 1e-6) * (2 * math.pi)
    x = x / (x[..., :, -1:] + 1e-6) * (2 * math.pi)
    dt = _dim_t(n, 10000.0, mask.device)
    return torch.cat([interleave_sincos(y[..., None] / dt), interleave_sincos(x[..., None] / dt)],
                     -1)


def sine_time(max_len: int, d: int, device):
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    te = torch.zeros(max_len, d, dtype=torch.float32, device=device)
    te[:, 0::2] = torch.sin(pos * div)
    te[:, 1::2] = torch.cos(pos * div)
    return te


def anchor_sine(pos, d_half: int):
    dt = _dim_t(d_half, 10000.0, pos.device)

    def emb(c):
        return interleave_sincos((c * (2 * math.pi))[..., None] / dt)

    return torch.cat([emb(pos[..., 1]), emb(pos[..., 0]), emb(pos[..., 2]), emb(pos[..., 3])],
                     -1)


def downsample_mask(mask, out_hw):
    h, w = mask.shape[-2:]
    ys = (torch.arange(out_hw[0], dtype=torch.float32, device=mask.device) * (h / out_hw[0])).long()
    xs = (torch.arange(out_hw[1], dtype=torch.float32, device=mask.device) * (w / out_hw[1])).long()
    return mask[..., ys, :][..., :, xs]


# --------------------------------------------------------------------------
# backbone
# --------------------------------------------------------------------------

class FrozenBN(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        for name, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                            ("running_var", 1.0 - BN_EPS)):
            self.register_buffer(name, torch.full((n,), value))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        bias = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + bias[None, :, None, None]


class Bottleneck(nn.Module):
    def __init__(self, ops: Ops, cin: int, planes: int, stride: int, downsample: bool,
                 dilation: int = 1):
        super().__init__()
        self.ops, self.stride, self.dilation = ops, stride, dilation
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = FrozenBN(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBN(planes * 4)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, planes * 4, 1, stride=stride, bias=False),
                                         FrozenBN(planes * 4)) if downsample else None)

    def forward(self, x):
        c = self.ops.conv
        out = torch.relu(self.bn1(c(x, self.conv1.weight)))
        out = torch.relu(self.bn2(c(out, self.conv2.weight, self.stride, self.dilation,
                                     self.dilation)))
        out = self.bn3(c(out, self.conv3.weight))
        if self.downsample is not None:
            x = self.downsample[1](c(x, self.downsample[0].weight, self.stride))
        return torch.relu(out + x)


class ResNet(nn.Module):
    """NHWC frames in, NHWC layer4 features out; the stem and the first
    ``frozen`` stages run without gradients; ``remat`` recomputes the
    trainable blocks in the backward (memory only: the same arithmetic).
    ``dc5`` trades layer4's stride for dilation as torchvision's
    ``_make_layer`` does: the stage's first block keeps the dilation before
    it, the later ones take the stride's."""

    def __init__(self, ops: Ops, depths=(3, 4, 23, 3), frozen: int = 1, dc5: bool = False):
        super().__init__()
        self.ops, self.frozen, self.remat = ops, frozen, False
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(64)
        cin, rate = 64, 1
        for i, (depth, planes) in enumerate(zip(depths, (64, 128, 256, 512))):
            stride, first_rate = (1 if i == 0 else 2), rate
            if dc5 and i == 3:
                rate, stride = rate * stride, 1
            blocks = []
            for j in range(depth):
                blocks.append(Bottleneck(ops, cin, planes, stride if j == 0 else 1, j == 0,
                                         first_rate if j == 0 else rate))
                cin = planes * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            x = torch.relu(self.bn1(self.ops.conv(x, self.conv1.weight, 2, 3)))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            for i in range(self.frozen):
                x = getattr(self, f"layer{i + 1}")(x)
        for i in range(self.frozen, 4):
            for block in getattr(self, f"layer{i + 1}"):
                if self.remat and torch.is_grad_enabled():
                    x = torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False)
                else:
                    x = block(x)
        return x.permute(0, 2, 3, 1)


class _Backbone(nn.Module):
    def __init__(self, body):
        super().__init__()
        self.body = body


class _NoParams(nn.Module):
    pass


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def attention(ops: Ops, q, k, v, key_valid=None, p: float = 0.0, generator=None,
              weights_out: bool = False):
    """q [B,H,Lq,D], k [B,H,Lk,D], v [B,H,Lk,Dv] -> (out, head-mean weights)."""
    logits = ops.einsum("bhqd,bhkd->bhqk", q * q.shape[-1] ** -0.5, k)
    if key_valid is not None:
        logits = torch.where(key_valid[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    logits = logits - logits.amax(-1, keepdim=True).detach()
    weights = torch.softmax(logits, dim=-1)
    out = ops.einsum("bhqk,bhkd->bhqd", dropout(weights, p, True, generator), v)
    return out, (weights.mean(1) if weights_out else None)


def split_heads(x, h: int):
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h).transpose(1, 2)


def merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class Linear(nn.Linear):
    def __init__(self, ops: Ops, din: int, dout: int):
        super().__init__(din, dout)
        self.ops = ops

    def forward(self, x):
        return self.ops.linear(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class MHA(nn.Module):
    def __init__(self, ops: Ops, d: int, heads: int, p: float):
        super().__init__()
        self.ops, self.d, self.heads, self.p = ops, d, heads, p
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = Linear(ops, d, d)

    def forward(self, q, k, v, key_valid=None, weights_out=False, generator=None):
        w, b = self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)
        proj = [split_heads(self.ops.linear(x, w[i], b[i]), self.heads)
                for i, x in enumerate((q, k, v))]
        out, weights = attention(self.ops, *proj, key_valid, self.p if self.training else 0.0,
                                 generator, weights_out)
        return self.out_proj(merge_heads(out)), weights


class ProjectionFree(nn.Module):
    def __init__(self, ops: Ops, d: int, heads: int, p: float):
        super().__init__()
        self.ops, self.heads, self.p = ops, heads, p
        self.out_proj = Linear(ops, d, d)

    def forward(self, q, k, v, key_valid=None, generator=None):
        h = self.heads
        out, _ = attention(self.ops, split_heads(q, h), split_heads(k, h), split_heads(v, h),
                           key_valid, self.p if self.training else 0.0, generator)
        return self.out_proj(merge_heads(out))


# --------------------------------------------------------------------------
# text
# --------------------------------------------------------------------------

class _Embeddings(nn.Module):
    def __init__(self, t):
        super().__init__()
        self.p = t["DROPOUT"]
        self.word_embeddings = nn.Embedding(t["VOCAB_SIZE"], t["HIDDEN"])
        self.position_embeddings = nn.Embedding(t["MAX_POS"], t["HIDDEN"])
        self.token_type_embeddings = nn.Embedding(1, t["HIDDEN"])
        self.LayerNorm = LayerNorm(t["HIDDEN"], eps=1e-5)

    def forward(self, ids, valid, generator):
        mask = valid.long()
        pos = torch.cumsum(mask, 1) * mask + 1
        x = (self.word_embeddings(ids.long()) + self.position_embeddings(pos)
             + self.token_type_embeddings(torch.zeros_like(ids, dtype=torch.long)))
        return dropout(self.LayerNorm(x), self.p, self.training, generator)


class _Self(nn.Module):
    def __init__(self, ops, t):
        super().__init__()
        self.ops, self.heads, self.p = ops, t["HEADS"], t["DROPOUT"]
        hid = t["HIDDEN"]
        self.query, self.key, self.value = (Linear(ops, hid, hid) for _ in range(3))

    def forward(self, x, valid, generator):
        h = self.heads
        out, _ = attention(self.ops, split_heads(self.query(x), h), split_heads(self.key(x), h),
                           split_heads(self.value(x), h), valid,
                           self.p if self.training else 0.0, generator)
        return merge_heads(out)


class _Out(nn.Module):
    def __init__(self, ops, din, dout, p):
        super().__init__()
        self.p = p
        self.dense = Linear(ops, din, dout)
        self.LayerNorm = LayerNorm(dout, eps=1e-5)

    def forward(self, h, residual, generator):
        return self.LayerNorm(residual + dropout(self.dense(h), self.p, self.training, generator))


class _Attn(nn.Module):
    def __init__(self, ops, t):
        super().__init__()
        self.self = _Self(ops, t)
        self.output = _Out(ops, t["HIDDEN"], t["HIDDEN"], 0.0)

    def forward(self, x, valid, generator):
        return self.output(self.self(x, valid, generator), x, generator)


class _Inter(nn.Module):
    def __init__(self, ops, t):
        super().__init__()
        self.dense = Linear(ops, t["HIDDEN"], t["INTERMEDIATE"])

    def forward(self, x):
        return F.gelu(self.dense(x))


class _Layer(nn.Module):
    def __init__(self, ops, t):
        super().__init__()
        self.attention = _Attn(ops, t)
        self.intermediate = _Inter(ops, t)
        self.output = _Out(ops, t["INTERMEDIATE"], t["HIDDEN"], t["DROPOUT"])

    def forward(self, x, valid, generator):
        x = self.attention(x, valid, generator)
        return self.output(self.intermediate(x), x, generator)


class _Stack(nn.Module):
    def __init__(self, ops, t):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(ops, t) for _ in range(t["LAYERS"]))


class _Pooler(nn.Module):
    def __init__(self, ops, t):
        super().__init__()
        self.dense = Linear(ops, t["HIDDEN"], t["HIDDEN"])

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class Roberta(nn.Module):
    def __init__(self, ops, t):
        super().__init__()
        self.embeddings = _Embeddings(t)
        self.encoder = _Stack(ops, t)
        self.pooler = _Pooler(ops, t)

    def forward(self, ids, valid, generator):
        x = self.embeddings(ids, valid, generator)
        for layer in self.encoder.layer:
            x = layer(x, valid, generator)
        return x, self.pooler(x)


class Resizer(nn.Module):
    def __init__(self, ops, din, dout, p):
        super().__init__()
        self.p = p
        self.fc = Linear(ops, din, dout)
        self.layer_norm = LayerNorm(dout, eps=1e-12)

    def forward(self, x, generator):
        return dropout(self.layer_norm(self.fc(x)), self.p, self.training, generator)


class TextEncoder(nn.Module):
    def __init__(self, ops, t, d):
        super().__init__()
        self.body = Roberta(ops, t)
        self.resizer = Resizer(ops, t["HIDDEN"], d, t["DROPOUT"])

    def forward(self, ids, valid, generator):
        hidden, pooled = self.body(ids, valid.bool(), generator)
        return self.resizer(hidden, generator), self.resizer(pooled, generator)


# --------------------------------------------------------------------------
# encoder and decoders
# --------------------------------------------------------------------------

class EncoderLayer(nn.Module):
    def __init__(self, ops, d, heads, ffn, p):
        super().__init__()
        self.p = p
        self.self_attn = MHA(ops, d, heads, p)
        self.linear1, self.linear2 = Linear(ops, d, ffn), Linear(ops, ffn, d)
        self.norm1, self.norm2 = LayerNorm(d, eps=1e-5), LayerNorm(d, eps=1e-5)

    def forward(self, x, pos, valid, generator):
        drop = lambda h: dropout(h, self.p, self.training, generator)  # noqa: E731
        qk = x + pos
        attn, _ = self.self_attn(qk, qk, x, valid, generator=generator)
        x = self.norm1(x + drop(attn))
        h = drop(torch.relu(self.linear1(x)))
        return self.norm2(x + drop(self.linear2(h)))


class Encoder(nn.Module):
    def __init__(self, ops, d, heads, ffn, layers, max_len, p):
        super().__init__()
        self.max_len = max_len + 1
        self.spatial_layers = nn.ModuleList(EncoderLayer(ops, d, heads, ffn, p)
                                            for _ in range(layers))
        self.temporal_layers = nn.ModuleList(EncoderLayer(ops, d, heads, ffn, p)
                                             for _ in range(layers))
        self.frame_cls = nn.Embedding(1, d)
        self.video_cls = nn.Embedding(1, d)
        self.local_pos_embed = nn.Embedding(1, d)

    def forward(self, feats, vis_valid, vis_pos, text, text_valid, frame_valid, generator):
        b, t, hf, wf, d = feats.shape
        l, hw, dev = text.shape[1], hf * wf, feats.device
        x = torch.cat([self.frame_cls.weight[0].expand(b, t, 1, d), feats.reshape(b, t, hw, d),
                       text[:, None].expand(b, t, l, d)], 2)
        pos = torch.cat([self.local_pos_embed.weight[0].expand(b, t, 1, d),
                         vis_pos.reshape(b, t, hw, d), torch.zeros(b, t, l, d, device=dev)], 2)
        valid = torch.cat([torch.ones(b, t, 1, dtype=torch.bool, device=dev),
                           vis_valid.reshape(b, t, hw), text_valid[:, None].expand(b, t, l)], 2)
        s = 1 + hw + l
        time_pos = sine_time(self.max_len, d, dev)[: t + 1].expand(b, t + 1, d)
        temp_valid = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=dev), frame_valid], 1)
        video_cls = self.video_cls.weight[0].expand(b, d)
        pos_f, valid_f = pos.reshape(b * t, s, d), valid.reshape(b * t, s)
        for spatial, temporal in zip(self.spatial_layers, self.temporal_layers):
            x = spatial(x.reshape(b * t, s, d), pos_f, valid_f, generator).reshape(b, t, s, d)
            seq = temporal(torch.cat([video_cls[:, None], x[:, :, 0]], 1), time_pos, temp_valid,
                           generator)
            video_cls = seq[:, 0]
            new_cls = torch.where(frame_valid[..., None], seq[:, 1:], x[:, :, 0])
            x = torch.cat([new_cls[:, :, None], x[:, :, 1:]], 2)
        return x[:, :, 1:], valid[:, :, 1:], x[:, :, 0], video_cls


class _GroundEncoder(nn.Module):
    def __init__(self, enc):
        super().__init__()
        self.encoder = enc


class MLP(nn.Module):
    def __init__(self, ops, din, hidden, dout, n, p=0.0):
        super().__init__()
        self.p = p
        dims = [din] + [hidden] * (n - 1) + [dout]
        self.layers = nn.ModuleList(Linear(ops, a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x, generator=None):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
            x = dropout(x, self.p, self.training, generator)
        return x


class TemplateGenerator(nn.Module):
    def __init__(self, ops, d, qdim):
        super().__init__()
        self.content_proj, self.gamma_proj, self.beta_proj = (Linear(ops, d, d) for _ in range(3))
        self.anchor_proj = Linear(ops, d, qdim)

    def forward(self, frames_cls, videos_cls):
        gamma = torch.tanh(self.gamma_proj(videos_cls))
        beta = torch.tanh(self.beta_proj(videos_cls))
        anchors = self.anchor_proj(gamma[:, None] * frames_cls + beta[:, None])
        return anchors, self.content_proj(videos_cls)[:, None].expand(frames_cls.shape)


SA_CA = ("sa_qcontent_proj", "sa_qpos_proj", "sa_qtime_proj", "sa_kcontent_proj", "sa_kpos_proj",
         "sa_ktime_proj", "sa_v_proj", "ca_qcontent_proj", "ca_kcontent_proj", "ca_kpos_proj",
         "ca_v_proj", "ca_qpos_sine_proj")


class SpatialLayer(nn.Module):
    def __init__(self, ops, d, heads, ffn, p, first):
        super().__init__()
        self.d, self.heads, self.p = d, heads, p
        for name in SA_CA:
            self.add_module(name, Linear(ops, d, d))
        self.ca_qpos_proj = Linear(ops, d, d) if first else None
        self.self_attn = MHA(ops, d, heads, p)
        self.cross_attn = ProjectionFree(ops, d, heads, p)
        self.linear1, self.linear2 = Linear(ops, d, ffn), Linear(ops, ffn, d)
        self.norm1, self.norm3, self.norm4 = (LayerNorm(d, eps=1e-5) for _ in range(3))

    def forward(self, tgt, memory, mem_valid, mem_pos, query_pos, query_time, sine, frame_valid,
                generator):
        drop = lambda x: dropout(x, self.p, self.training, generator)  # noqa: E731
        q = self.sa_qcontent_proj(tgt) + self.sa_qtime_proj(query_time) + self.sa_qpos_proj(query_pos)
        k = self.sa_kcontent_proj(tgt) + self.sa_ktime_proj(query_time) + self.sa_kpos_proj(query_pos)
        v = self.sa_v_proj(tgt)
        sa, _ = self.self_attn(q, k, v, frame_valid, weights_out=True, generator=generator)
        tgt = self.norm1(tgt + drop(sa))
        b, t, m, _ = memory.shape
        qc, kc = self.ca_qcontent_proj(tgt), self.ca_kcontent_proj(memory)
        vm, kp = self.ca_v_proj(memory), self.ca_kpos_proj(mem_pos)
        if self.ca_qpos_proj is not None:
            qc = qc + self.ca_qpos_proj(query_pos)
            kc = kc + kp
        sine = self.ca_qpos_sine_proj(sine)
        h, hd = self.heads, self.d // self.heads
        qcat = torch.cat([qc.reshape(b, t, h, hd), sine.reshape(b, t, h, hd)], -1)
        kcat = torch.cat([kc.reshape(b, t, m, h, hd), kp.reshape(b, t, m, h, hd)], -1)
        ca = self.cross_attn(qcat.reshape(b * t, 1, 2 * self.d), kcat.reshape(b * t, m, 2 * self.d),
                             vm.reshape(b * t, m, self.d), mem_valid.reshape(b * t, m), generator)
        ca = torch.where(frame_valid[..., None], ca.reshape(b, t, self.d), 0.0)
        tgt = self.norm3(tgt + drop(ca))
        ff = self.linear2(drop(torch.relu(self.linear1(tgt))))
        return self.norm4(tgt + drop(ff))


class SpatialDecoder(nn.Module):
    def __init__(self, ops, d, heads, ffn, layers, qdim, p):
        super().__init__()
        self.d, self.qdim = d, qdim
        self.query_scale = MLP(ops, d, d, d, 2)
        self.ref_point_head = MLP(ops, qdim * d // 2, d, d, 2)
        self.norm = LayerNorm(d, eps=1e-5)
        self.layers = nn.ModuleList(SpatialLayer(ops, d, heads, ffn, p, i == 0)
                                    for i in range(layers))

    def forward(self, anchors, memory, mem_valid, mem_pos, query_time, frame_valid, bbox_embed,
                generator):
        d = self.d
        tgt = torch.zeros(anchors.shape[:2] + (d,), device=anchors.device)
        hs, refs = [], [anchors]
        for i, layer in enumerate(self.layers):
            sine2d = anchor_sine(anchors, d // 2)
            query_pos = self.ref_point_head(sine2d)
            scale = 1.0 if i == 0 else self.query_scale(tgt)
            tgt = layer(tgt, memory, mem_valid, mem_pos, query_pos, query_time, sine2d[..., :d] * scale,
                        frame_valid, generator)
            delta = bbox_embed(tgt, generator)
            new = torch.sigmoid(delta[..., : self.qdim] + inverse_sigmoid(anchors))
            if i != len(self.layers) - 1:
                refs.append(new)
            anchors = new.detach()
            hs.append(self.norm(tgt))
        return torch.stack(hs), torch.stack(refs)


class TimeLayer(nn.Module):
    def __init__(self, ops, d, heads, ffn, p):
        super().__init__()
        self.p = p
        self.self_attn = MHA(ops, d, heads, p)
        self.cross_attn_image = MHA(ops, d, heads, p)
        self.linear1, self.linear2 = Linear(ops, d, ffn), Linear(ops, ffn, d)
        self.norm1, self.norm3, self.norm4 = (LayerNorm(d, eps=1e-5) for _ in range(3))

    def forward(self, tgt, memory, mem_valid, mem_pos, query_pos, time_pos, frame_valid, generator):
        drop = lambda x: dropout(x, self.p, self.training, generator)  # noqa: E731
        qk = tgt + query_pos + time_pos
        sa, weights = self.self_attn(qk, qk, tgt, frame_valid, weights_out=True, generator=generator)
        tgt = self.norm1(tgt + drop(sa))
        b, t, m, d = memory.shape
        ca, _ = self.cross_attn_image((tgt + query_pos).reshape(b * t, 1, d),
                                      (memory + mem_pos).reshape(b * t, m, d),
                                      memory.reshape(b * t, m, d), mem_valid.reshape(b * t, m),
                                      generator=generator)
        ca = torch.where(frame_valid[..., None], ca.reshape(b, t, d), 0.0)
        tgt = self.norm3(tgt + drop(ca))
        ff = self.linear2(drop(torch.relu(self.linear1(tgt))))
        return self.norm4(tgt + drop(ff)), weights


class TimeDecoder(nn.Module):
    def __init__(self, ops, d, heads, ffn, layers, p):
        super().__init__()
        self.d = d
        self.norm = LayerNorm(d, eps=1e-5)
        self.layers = nn.ModuleList(TimeLayer(ops, d, heads, ffn, p) for _ in range(layers))

    def forward(self, memory, mem_valid, mem_pos, query_pos, time_pos, frame_valid, generator):
        b, t = frame_valid.shape
        tgt = torch.zeros(b, t, self.d, device=memory.device)
        states, weights = [], []
        for layer in self.layers:
            tgt, w = layer(tgt, memory, mem_valid, mem_pos, query_pos, time_pos, frame_valid,
                           generator)
            states.append(self.norm(tgt))
            weights.append(w)
        return torch.stack(states), torch.stack(weights)


class _GroundDecoder(nn.Module):
    def __init__(self, tg, dec, tdec):
        super().__init__()
        self.template_generator, self.decoder, self.temp_decoder = tg, dec, tdec
        self.time_embed = _NoParams()


class STCAT(nn.Module):
    """``arch``: the configuration's sizes (``arch_of(cfg)``). forward(frames
    [B,T,H,W,3] normalised, frame_valid, pixel_valid, token_ids,
    token_valid, generator) -> the port's output dict."""

    def __init__(self, arch: Dict, ops: Ops = FP32):
        super().__init__()
        a, d = arch, arch["HIDDEN"]
        self.arch, self.d = a, d
        frozen = 4 if a["VIS_BACKBONE_LR"] <= 0 else 1
        body = ResNet(ops, tuple(a["DEPTHS"]), frozen, a["DILATION"])
        self.vis_encoder = nn.ModuleList([_Backbone(body), _NoParams()])
        self.input_proj = nn.Conv2d(2048, d, 1)
        self.ops = ops
        self.text_encoder = TextEncoder(ops, a["TEXT"], d)
        p, heads, ffn = a["DROPOUT"], a["HEADS"], a["FFN_DIM"]
        self.ground_encoder = _GroundEncoder(Encoder(ops, d, heads, ffn, a["ENC_LAYERS"],
                                                     a["MAX_VIDEO_LEN"], p))
        self.ground_decoder = _GroundDecoder(
            TemplateGenerator(ops, d, a["QUERY_DIM"]),
            SpatialDecoder(ops, d, heads, ffn, a["DEC_LAYERS"], a["QUERY_DIM"], p),
            TimeDecoder(ops, d, heads, ffn, a["DEC_LAYERS"], p))
        self.bbox_embed = MLP(ops, d, d, 4, 3)
        self.temp_embed = MLP(ops, d, d, 2, 2, a["HEAD_DROPOUT"])
        self.action_embed = MLP(ops, d, d, 1, 2, a["HEAD_DROPOUT"])
        self.max_len = a["MAX_VIDEO_LEN"] + 1

    def forward(self, frames, frame_valid, pixel_valid, token_ids, token_valid, generator=None):
        b, t, h, w, _ = frames.shape
        d = self.d
        frame_valid = frame_valid.bool()
        feats = self.vis_encoder[0].body(frames.reshape(b * t, h, w, 3))
        hf, wf = feats.shape[1:3]
        feats = self.ops.linear(feats, self.input_proj.weight[:, :, 0, 0], self.input_proj.bias)
        feats = feats.reshape(b, t, hf, wf, d)
        vis_valid = downsample_mask(pixel_valid.bool(), (hf, wf))
        vis_pos = sine_position_2d(vis_valid, d // 2)
        text, _ = self.text_encoder(token_ids, token_valid, generator)
        memory, mem_valid, frames_cls, videos_cls = self.ground_encoder.encoder(
            feats, vis_valid, vis_pos, text, token_valid.bool(), frame_valid, generator)
        l = text.shape[1]
        mem_pos = torch.cat([vis_pos.reshape(b, t, hf * wf, d),
                             torch.zeros(b, t, l, d, device=frames.device)], 2)
        gd = self.ground_decoder
        anchor_logits, content = gd.template_generator(frames_cls, videos_cls)
        fv = frame_valid[..., None]
        anchors = torch.where(fv, torch.sigmoid(anchor_logits), 0.0)
        content = torch.where(fv, content, 0.0)
        query_time = sine_time(self.max_len, d, frames.device)[:t][None].expand(b, t, d)
        hs, reference = gd.decoder(anchors, memory, mem_valid, mem_pos, query_time, frame_valid,
                                   self.bbox_embed, generator)
        time_hs, weights = gd.temp_decoder(memory, mem_valid, mem_pos, content, query_time,
                                           frame_valid, generator)
        delta = self.bbox_embed(hs, generator)
        coords = torch.sigmoid(delta[..., :4] + inverse_sigmoid(reference))
        sted = self.temp_embed(time_hs, generator)
        act = self.action_embed(time_hs, generator)
        out = {"pred_boxes": coords[-1], "pred_sted": sted[-1], "weights": weights[-1],
               "pred_actioness": act[-1]}
        out["aux_outputs"] = [{"pred_boxes": coords[i], "pred_sted": sted[i],
                               "weights": weights[i], "pred_actioness": act[i]}
                              for i in range(coords.shape[0] - 1)]
        return out


# Configuration keys (dotted, the port's names) that the reference follows:
# the model's here through ``arch_of``, the loss's in ``reference/train.py``
# and the inputs' in ``reference/infer.py``.
MODELLED = (
    "MODEL.VISION_BACKBONE.DEPTHS", "MODEL.VISION_BACKBONE.DILATION",
    *(f"MODEL.TEXT_MODEL.{k}" for k in ("VOCAB_SIZE", "HIDDEN", "LAYERS", "HEADS",
                                        "INTERMEDIATE", "MAX_POS", "DROPOUT")),
    *(f"MODEL.STCAT.{k}" for k in ("HIDDEN", "HEADS", "FFN_DIM", "ENC_LAYERS", "DEC_LAYERS",
                                   "DROPOUT", "HEAD_DROPOUT")),
    "SOLVER.VIS_BACKBONE_LR", "INPUT.MAX_VIDEO_LEN", "INPUT.PIXEL_MEAN", "INPUT.PIXEL_STD",
    *(f"SOLVER.{k}" for k in ("BBOX_COEF", "GIOU_COEF", "TEMP_COEF", "ATTN_COEF",
                              "ACTIONESS_COEF", "SIGMA", "EOS_COEF")),
)

# Keys the reference models at these values only (the port's default among
# them, so a file that leaves one out passes); ``arch_of`` refuses any other.
ONLY = {
    "MODEL.VISION_BACKBONE.NAME": ("resnet101", "resnet50"),  # no GroupNorm ("-gn") body
    "MODEL.VISION_BACKBONE.POS_ENC": ("sine",),
    "MODEL.VISION_BACKBONE.FREEZE": (False,),  # the reference trains the body at its LR
    "MODEL.TEXT_MODEL.FREEZE": (False,),
    "MODEL.TEXT_MODEL.LOCAL_PATH": ("",),  # the reference tokenizes by hash
    "MODEL.USE_LSTM": (False,),
    "MODEL.QUERY_NUM": (1,),  # one query per frame
    "MODEL.STCAT.QUERY_DIM": (4,),  # anchors (cx, cy, w, h)
    "MODEL.STCAT.USE_LEARN_TIME_EMBED": (False,),
    "MODEL.STCAT.USE_ACTION": (True,),
    "MODEL.STCAT.FROM_SCRATCH": (True,),  # projection-free cross-attention
    "SOLVER.USE_ATTN": (True,),
    "SOLVER.USE_AUX_LOSS": (True,),
}

# Keys that change neither the forward nor the loss the benchmark compares
# (a trailing "." names a whole group), each with why.
INERT = {
    "MODEL.WEIGHT": "a weight file to load; the benchmark draws the weights from the seed "
                    "and hands the same to both sides",
    "MODEL.EMA": "the averaged copy of the weights the training step keeps; no compared "
                 "forward, loss or update reads it",
    "MODEL.EMA_DECAY": "the same averaged copy's rate",
    "MODEL.TEXT_MODEL.NAME": "read by no code of the port; the text encoder's sizes are the "
                             "keys beside it",
    "MODEL.TEXT_MODEL.ALLOW_HASH_TOKENIZER": "only lets the port run the hash tokenizer, which "
                                             "is the one the reference runs",
    "MODEL.LSTM.": "read only with MODEL.USE_LSTM, which is refused",
}

_ABSENT = object()


def _lookup(cfg: Dict, key: str):
    node = cfg
    for part in key.split("."):
        if not isinstance(node, dict) or part not in node:
            return _ABSENT
        node = node[part]
    return node


def arch_of(cfg: Dict) -> Dict:
    """The sizes the reference reads, from a configuration file's merged
    recipe (nested dicts with the port's key names). Raises ValueError,
    naming the key and its value, for a key of ``ONLY`` set to a value the
    reference does not model."""
    for key, values in ONLY.items():
        value = _lookup(cfg, key)
        if value is not _ABSENT and value not in values:
            raise ValueError(f"{key} = {value!r}: the plain reference models only "
                             f"{' or '.join(map(repr, values))}, so it cannot judge this "
                             f"configuration")
    m, s = cfg["MODEL"], cfg["MODEL"]["STCAT"]
    depths = {"resnet101": (3, 4, 23, 3), "resnet50": (3, 4, 6, 3)}
    vb = m["VISION_BACKBONE"]
    return {
        "DEPTHS": tuple(vb.get("DEPTHS") or depths[vb["NAME"]]),
        "DILATION": bool(vb.get("DILATION", False)),
        "VIS_BACKBONE_LR": cfg["SOLVER"]["VIS_BACKBONE_LR"],
        "HIDDEN": s["HIDDEN"], "HEADS": s["HEADS"], "FFN_DIM": s["FFN_DIM"],
        "ENC_LAYERS": s["ENC_LAYERS"], "DEC_LAYERS": s["DEC_LAYERS"],
        "QUERY_DIM": s["QUERY_DIM"], "DROPOUT": s["DROPOUT"], "HEAD_DROPOUT": s["HEAD_DROPOUT"],
        "MAX_VIDEO_LEN": cfg["INPUT"]["MAX_VIDEO_LEN"],
        "TEXT": {k: m["TEXT_MODEL"][k] for k in ("VOCAB_SIZE", "HIDDEN", "LAYERS", "HEADS",
                                                 "INTERMEDIATE", "MAX_POS", "DROPOUT")},
    }
