"""Small tensor helpers."""

from __future__ import annotations

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
