"""The benchmark's weights: one fp32 state_dict in the reference STCAT
layout, drawn from the run's seed on the device.

The draw is the one the port's published-scale parity test settled on, so
that outputs change from frame to frame and boxes stay inside the sigmoid's
range: each matrix and convolution at its fan-in's scale (2 / fan_in ahead
of a ReLU in the backbone), the box head's last layer at 0.1 x that, norm
scales 1 + N(0, 0.01), the residual branch's last norm and the projection's
at 0.2 x that, biases N(0, 0.01), embeddings N(0, 1), frozen batch-norm
statistics at the identity (mean 0, var 1 - eps). Every value comes from
one ``torch.randn`` over all keys in sorted order, on a ``torch.Generator``
of the device: a few large calls, the same bytes for a seed on one device.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .reference.model import BN_EPS, MHA, STCAT, FrozenBN, LayerNorm


def kinds(model: nn.Module) -> Dict[str, str]:
    """state_dict key -> draw kind."""
    out = {}
    for mname, mod in model.named_modules():
        pre = mname + "." if mname else ""
        for pname, _ in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            key = pre + pname
            if isinstance(mod, FrozenBN):
                branch = mname.endswith((".bn3", ".downsample.1"))
                out[key] = {"weight": "bn_branch_scale" if branch else "bn_scale",
                            "bias": "bias", "running_mean": "bn_mean",
                            "running_var": "bn_var"}[pname]
            elif pname.endswith("bias"):
                out[key] = "bias"
            elif key == "bbox_embed.layers.2.weight":
                out[key] = "box_delta"
            elif isinstance(mod, nn.Conv2d):
                out[key] = "conv_relu" if mname.startswith("vis_encoder.") else "conv"
            elif isinstance(mod, LayerNorm):
                out[key] = "scale"
            elif isinstance(mod, (nn.Linear, MHA)):
                out[key] = "matrix"
            else:
                out[key] = "embedding"
    return out


def _finish(kind: str, x: torch.Tensor, shape) -> torch.Tensor:
    fan_in = 1
    for s in shape[1:]:
        fan_in *= s
    if kind == "conv_relu":
        return x * (2.0 / fan_in) ** 0.5
    if kind in ("conv", "matrix"):
        return x * fan_in ** -0.5
    if kind == "box_delta":
        return x * (0.1 * fan_in ** -0.5)
    if kind in ("scale", "bn_scale"):
        return 1.0 + 0.1 * x
    if kind == "bn_branch_scale":
        return 0.2 * (1.0 + 0.1 * x)
    if kind == "bias":
        return 0.1 * x
    return x


@torch.no_grad()
def draw(arch: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded state_dict of the model ``arch`` describes, fp32 on
    ``device``."""
    with torch.device("meta"):
        model = STCAT(arch)
    kind = kinds(model)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    keys = sorted(shapes)
    drawn = [k for k in keys if not kind[k].startswith("bn_") or kind[k].endswith("scale")]
    sizes = [int(torch.Size(shapes[k]).numel()) for k in drawn]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for k, piece in zip(drawn, torch.split(flat, sizes)):
        out[k] = _finish(kind[k], piece.view(shapes[k]), shapes[k])
    for k in keys:
        if kind[k] == "bn_mean":
            out[k] = torch.zeros(shapes[k], device=device)
        elif kind[k] == "bn_var":
            out[k] = torch.full(shapes[k], 1.0 - BN_EPS, device=device)
    return {k: out[k] for k in keys}
