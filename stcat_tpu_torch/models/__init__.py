"""STCAT network and its components; ``build_model`` makes a seeded fresh one,
laid out on a mesh (``parallelize``) when it is given one."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core import mesh as meshlib
from ..ops.misc import resolve_device
from .attention import Linear, MultiHeadAttention, lecun_normal_, xavier_uniform_
from .lstm_text import LSTMTextEncoder
from .position2d import PositionEncoding2D
from .stcat import STCATNet


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights drawn from ``generator`` (on the CPU, so a seed gives the
    same weights on every device) from the JAX package's distributions:
    each ``Linear`` by its ``init`` (lecun-normal or xavier-uniform), every
    other matrix, convolution and attention input projection lecun-normal
    (truncated at 2 sigma; fan_in kh x kw x Cin for a convolution, d_model
    for each of q, k and v), zero biases, unit norms, normal(0, 1) learned
    tokens and time tables, normal(0, 1 / dim) text embeddings, uniform[0, 1)
    learned 2-D position tables. FrozenBN buffers stay the identity. An LSTM
    text encoder draws its own (``init_weights``)."""

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    owned = []  # modules that initialise themselves, with everything inside them
    for name, mod in model.named_modules():
        if any(name.startswith(prefix) for prefix in owned):
            continue
        if isinstance(mod, LSTMTextEncoder):
            mod.init_weights(generator)
            owned.append(name + ".")
        elif isinstance(mod, MultiHeadAttention):
            lecun_normal_(mod.in_proj_weight, mod.d_model, generator)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            if getattr(mod, "init", "lecun") == "xavier":
                xavier_uniform_(mod.weight, generator)
            else:
                lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, PositionEncoding2D) and mod.kind == "learned":
            for table in (mod.row_embed.weight, mod.col_embed.weight):
                table.copy_(torch.rand(table.shape, generator=generator))
        elif isinstance(mod, nn.Embedding) and not name.endswith(("row_embed", "col_embed")):
            std = 1.0 / math.sqrt(mod.embedding_dim) if name.startswith("text_encoder") else 1.0
            normal_(mod.weight, std)


def validate_tp(cfg, model_parallel: int) -> None:
    """The head and hidden widths tensor parallelism splits must divide by
    the model-parallel size (the JAX step's ``_validate_tp``)."""
    st, tm = cfg.MODEL.STCAT, cfg.MODEL.TEXT_MODEL
    for name, val in (
        ("STCAT.HEADS", st.HEADS),
        ("STCAT.FFN_DIM", st.FFN_DIM),
        ("TEXT_MODEL.HEADS", tm.HEADS),
        ("TEXT_MODEL.INTERMEDIATE", tm.INTERMEDIATE),
    ):
        if val % model_parallel:
            raise ValueError(
                f"MODEL.{name}={val} not divisible by model-parallel size {model_parallel}"
            )


def min_tp_leaves(cfg) -> int:
    """Loose lower bound on the model-sharded parameters: every encoder and
    decoder layer holds at least one column- and one row-parallel weight, so
    a name-rule drift that drops a whole stack to replication trips
    ``mesh.sharded_names``' guard."""
    s = cfg.MODEL.STCAT
    return 2 * (s.ENC_LAYERS + 2 * s.DEC_LAYERS)


@torch.no_grad()
def parallelize(cfg, model: STCATNet, mesh) -> STCATNet:
    """Lay a whole model out on ``mesh``, in place: under tensor parallelism
    each sharded parameter keeps this rank's part (``mesh.tp_rule``) and the
    tensor-parallel modules their ``tp``, each row-parallel Linear its
    ``row_parallel``; under sequence parallelism the model gets its
    ``frame_shard``. Call it before the optimizer sees the parameters."""
    model.mesh = mesh
    model.frame_shard = meshlib.frame_shard(mesh)
    tp = meshlib.model_shard(mesh)
    if tp is None:
        return model
    validate_tp(cfg, tp.parts)
    rules = meshlib.sharded_names(((n, p.dim()) for n, p in model.named_parameters()),
                                  min_model_sharded=min_tp_leaves(cfg))
    for name, p in model.named_parameters():
        if name in rules:
            p.data = meshlib.shard_tensor(p.data, rules[name], tp.index, tp.parts)
    for name, mod in model.named_modules():
        if hasattr(mod, "tp"):
            mod.tp = tp
        if isinstance(mod, Linear) and rules.get(name + ".weight") == (1, 1):
            mod.row_parallel = tp
    return model


def build_model(cfg, device=None, seed: int = 0, mesh=None) -> STCATNet:
    """A fresh STCATNet on ``device`` (``cuda`` unless "cpu" is asked for),
    in eval mode, with weights drawn from ``seed`` (the same weights on every
    layout: a mesh's ranks keep their parts of them)."""
    dev = resolve_device(device)
    model = STCATNet(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    if mesh is not None:
        parallelize(cfg, model, mesh)
    return model.to(dev).eval()


__all__ = ["STCATNet", "build_model", "init_parameters", "parallelize"]
