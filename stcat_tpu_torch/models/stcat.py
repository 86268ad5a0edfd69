"""STCAT network assembly: vision + text encoders, cross-modal encoder, query
decoders and prediction heads.

The forward takes a fixed-shape VideoBatch and returns
{pred_boxes [B,T,4], pred_sted [B,T,2], pred_actioness [B,T,1], weights
[B,T,T], aux_outputs [...]} as the JAX package's STCATNet does. Module names
follow the reference STCAT state_dict (vis_encoder.0.body.*, input_proj,
text_encoder.body/resizer, ground_encoder.encoder.*, ground_decoder.*,
bbox_embed, temp_embed, action_embed).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..config import Config
from ..core.batch import VideoBatch
from ..ops.misc import inverse_sigmoid
from .decoder import MLP, SpatialDecoder, TemplateGenerator, TimeDecoder
from .encoder import CrossModalEncoder, TimeEmbedding
from .position2d import PositionEncoding2D
from .resnet import build_resnet, downsample_mask
from .roberta import RobertaConfig, TextEncoder


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class _Backbone(nn.Module):
    def __init__(self, body: nn.Module):
        super().__init__()
        self.body = body


class _GroundEncoder(nn.Module):
    def __init__(self, encoder: CrossModalEncoder):
        super().__init__()
        self.encoder = encoder


class _GroundDecoder(nn.Module):
    def __init__(self, template_generator, decoder, temp_decoder, time_embed):
        super().__init__()
        self.template_generator = template_generator
        self.decoder = decoder
        self.temp_decoder = temp_decoder
        self.time_embed = time_embed


class STCATNet(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        c, s = cfg, cfg.MODEL.STCAT
        if c.MODEL.USE_LSTM:
            raise NotImplementedError(
                "MODEL.USE_LSTM (models/lstm_text.py) is not ported yet: see ROADMAP.md, "
                "Queue A, 'lstm_text.py'"
            )
        d = self.d_model = s.HIDDEN
        dtype = self.compute_dtype = _dtype(c.TPU.COMPUTE_DTYPE)
        vb = c.MODEL.VISION_BACKBONE
        self.vis_encoder = nn.ModuleList([
            _Backbone(build_resnet(vb.NAME, vb.DILATION, dtype=dtype, depths=vb.DEPTHS,
                                   conv_impl=c.TPU.CONV_IMPL, conv_stages=c.TPU.CONV_STAGES)),
            PositionEncoding2D(vb.POS_ENC, d // 2),
        ])
        self.input_proj = nn.Conv2d(2048, d, 1)
        tm = c.MODEL.TEXT_MODEL
        self.text_encoder = TextEncoder(d, RobertaConfig(
            vocab_size=tm.VOCAB_SIZE, hidden_size=tm.HIDDEN, num_layers=tm.LAYERS,
            num_heads=tm.HEADS, intermediate_size=tm.INTERMEDIATE,
            max_position_embeddings=tm.MAX_POS,
        ), dtype)
        impl = c.TPU.ATTENTION_IMPL
        self.ground_encoder = _GroundEncoder(CrossModalEncoder(
            d, s.HEADS, s.FFN_DIM, s.ENC_LAYERS, c.INPUT.MAX_VIDEO_LEN,
            s.USE_LEARN_TIME_EMBED, dtype, impl,
        ))
        self.ground_decoder = _GroundDecoder(
            TemplateGenerator(d, s.QUERY_DIM),
            SpatialDecoder(d, s.HEADS, s.FFN_DIM, s.DEC_LAYERS, s.QUERY_DIM,
                           s.FROM_SCRATCH, dtype, impl),
            TimeDecoder(d, s.HEADS, s.FFN_DIM, s.DEC_LAYERS, dtype, impl),
            TimeEmbedding(c.INPUT.MAX_VIDEO_LEN + 1, d, s.USE_LEARN_TIME_EMBED),
        )
        self.bbox_embed = MLP(d, d, 4, 3)
        self.temp_embed = MLP(d, d, 2, 2)
        self.use_actioness = s.USE_ACTION
        if self.use_actioness:
            self.action_embed = MLP(d, d, 1, 2)
        self.use_attn = c.SOLVER.USE_ATTN
        self.use_aux_loss = c.SOLVER.USE_AUX_LOSS
        self.query_dim = s.QUERY_DIM

    def forward(self, batch: VideoBatch) -> Dict[str, Any]:
        b, t, h, w, _ = batch.frames.shape
        d, dt = self.d_model, self.compute_dtype
        frame_valid = batch.frame_valid.bool()

        # vision: frames fold into the batch axis
        feats = self.vis_encoder[0].body(batch.frames.to(dt).reshape(b * t, h, w, 3))
        hf, wf = feats.shape[1:3]
        wp = self.input_proj.weight[:, :, 0, 0].to(dt)
        feats = nn.functional.linear(feats, wp, self.input_proj.bias.to(dt))
        feats = feats.reshape(b, t, hf, wf, d).float()
        vis_valid = downsample_mask(batch.pixel_valid.bool(), (hf, wf))
        vis_pos = self.vis_encoder[1](vis_valid)

        text_feats, text_cls = self.text_encoder(batch.token_ids, batch.token_valid)
        memory, mem_valid, frames_cls, videos_cls = self.ground_encoder.encoder(
            feats, vis_valid, vis_pos, text_feats, batch.token_valid.bool(), frame_valid,
        )
        l = text_feats.shape[1]
        mem_pos = torch.cat([
            vis_pos.reshape(b, t, hf * wf, d),
            torch.zeros(b, t, l, d, dtype=vis_pos.dtype, device=vis_pos.device),
        ], dim=2)

        gd = self.ground_decoder
        anchor_logits, content_query = gd.template_generator(frames_cls, videos_cls)
        fv = frame_valid[..., None]
        anchors = torch.where(fv, torch.sigmoid(anchor_logits), 0.0)
        content_query = torch.where(fv, content_query, 0.0)
        query_time = gd.time_embed(t, feats.device)[None].expand(b, t, d)

        hs, reference = gd.decoder(anchors, memory, mem_valid, mem_pos, query_time,
                                   frame_valid, self.bbox_embed)
        time_hs, attn_weights = gd.temp_decoder(memory, mem_valid, mem_pos, content_query,
                                                query_time, frame_valid)

        delta = self.bbox_embed(hs)
        coords = torch.sigmoid(delta[..., : self.query_dim] + inverse_sigmoid(reference))
        sted = self.temp_embed(time_hs)
        out: Dict[str, Any] = {"pred_boxes": coords[-1], "pred_sted": sted[-1]}
        if self.use_attn:
            out["weights"] = attn_weights[-1]
        if self.use_actioness:
            actioness = self.action_embed(time_hs)
            out["pred_actioness"] = actioness[-1]
        if self.use_aux_loss:
            aux = []
            for i in range(coords.shape[0] - 1):
                a = {"pred_boxes": coords[i], "pred_sted": sted[i]}
                if self.use_attn:
                    a["weights"] = attn_weights[i]
                if self.use_actioness:
                    a["pred_actioness"] = actioness[i]
                aux.append(a)
            out["aux_outputs"] = aux
        return out
