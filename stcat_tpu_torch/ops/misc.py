"""Small tensor helpers."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Large negative used to kill attention/softmax logits at padded positions
# (not -inf: -inf * 0 = nan under masking arithmetic).
NEG_INF = -1e32


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Logit with clamping (DAB-DETR's inverse_sigmoid)."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; never a silent fallback."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None,
            shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - p and scale
    it by 1 / (1 - p), the keep mask drawn from ``generator`` (on x's
    device). The identity unless ``training`` and p > 0; then a generator
    is required, so that every mask can be drawn again.

    ``shard`` (dim, index, parts): x is part ``index`` of ``parts`` equal
    parts of a whole tensor along ``dim`` (tensor parallelism); the whole
    tensor's mask is drawn and this part's taken, so each part gets its own
    mask and the generator moves as it does in one process."""
    if not training or p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs an explicit torch.Generator")
    if shard is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    else:
        dim, index, parts = shard
        whole = list(x.shape)
        whole[dim] *= parts
        keep = torch.rand(whole, generator=generator, device=x.device).narrow(
            dim, index * x.shape[dim], x.shape[dim]) >= p
    return torch.where(keep, x / (1.0 - p), x.new_zeros(()))
