"""STCAT network and its components; ``build_model`` makes a seeded fresh one."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.misc import resolve_device
from .attention import MultiHeadAttention
from .lstm_text import LSTMTextEncoder
from .position2d import PositionEncoding2D
from .stcat import STCATNet


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights drawn from ``generator`` (on the CPU, so a seed gives the
    same weights on every device): lecun-normal matrices and convolutions,
    zero biases, unit norms, normal(0, 1) learned tokens and tables,
    uniform[0, 1) learned 2-D position tables. FrozenBN buffers stay the
    identity. An LSTM text encoder draws its own (``init_weights``)."""

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
            normal_(mod.in_proj_weight, 1.0 / math.sqrt(mod.d_model))
            mod.in_proj_bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            normal_(mod.weight, 1.0 / math.sqrt(mod.weight[0].numel()))
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


def build_model(cfg, device=None, seed: int = 0) -> STCATNet:
    """A fresh STCATNet on ``device`` (``cuda`` unless "cpu" is asked for),
    in eval mode, with weights drawn from ``seed``."""
    dev = resolve_device(device)
    model = STCATNet(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


__all__ = ["STCATNet", "build_model", "init_parameters"]
