"""2-D position encodings for the visual feature map: sine, sineHW, learned."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.embeddings import sine_position_embedding_2d


LEARNED_TABLE_SIZE = 50


class PositionEncoding2D(nn.Module):
    """Dispatch on MODEL.VISION_BACKBONE.POS_ENC (sine | sineHW | learned).

    "learned" holds row/col tables of 50 x d/2 each; the sine kinds hold no
    parameters (sineHW uses temperature 20 on both axes).
    """

    def __init__(self, kind: str, num_pos_feats: int):
        super().__init__()
        if kind not in ("sine", "sineHW", "learned"):
            raise ValueError(f"unsupported POS_ENC {kind}")
        self.kind = kind
        self.num_pos_feats = num_pos_feats
        if kind == "learned":
            self.row_embed = nn.Embedding(LEARNED_TABLE_SIZE, num_pos_feats)
            self.col_embed = nn.Embedding(LEARNED_TABLE_SIZE, num_pos_feats)

    def forward(self, pixel_mask: torch.Tensor) -> torch.Tensor:
        """[..., H, W] True=valid mask -> [..., H, W, 2*num_pos_feats] fp32."""
        if self.kind == "sine":
            return sine_position_embedding_2d(pixel_mask, self.num_pos_feats)
        if self.kind == "sineHW":
            return sine_position_embedding_2d(pixel_mask, self.num_pos_feats, 20.0, 20.0)
        h, w = pixel_mask.shape[-2:]
        n = self.num_pos_feats
        x_emb = self.col_embed.weight[:w]
        y_emb = self.row_embed.weight[:h]
        pos = torch.cat(
            [x_emb[None, :, :].expand(h, w, n), y_emb[:, None, :].expand(h, w, n)], dim=-1
        )
        return pos.expand(*pixel_mask.shape, 2 * n)
