"""Model outputs -> boxes in original pixels and decoded temporal spans."""

from __future__ import annotations

import torch

from ..ops.boxes import box_cxcywh_to_xyxy
from ..ops.sted import decode_sted


def postprocess(pred_boxes: torch.Tensor, pred_sted: torch.Tensor,
                orig_sizes: torch.Tensor, time_mask: torch.Tensor):
    """Returns (boxes_xyxy [B,T,4] original pixels, start_idx [B], end_idx [B])."""
    boxes = box_cxcywh_to_xyxy(pred_boxes.float())
    h = orig_sizes[:, 0:1].float()
    w = orig_sizes[:, 1:2].float()
    scale = torch.stack([w, h, w, h], dim=-1)  # [B, 1, 4]
    boxes = (boxes * scale).clamp(min=0.0)
    s_idx, e_idx = decode_sted(pred_sted, time_mask)
    return boxes, s_idx, e_idx
