"""STCAT network assembly: vision + text encoders, cross-modal encoder, query
decoders and prediction heads.

The forward takes a fixed-shape VideoBatch and returns
{pred_boxes [B,T,4], pred_sted [B,T,2], pred_actioness [B,T,1], weights
[B,T,T], aux_outputs [...]} as the JAX package's STCATNet does. Module names
follow the reference STCAT state_dict (vis_encoder.0.body.*, input_proj,
text_encoder.body/resizer, ground_encoder.encoder.*, ground_decoder.*,
bbox_embed, temp_embed, action_embed). With MODEL.USE_LSTM the text encoder
is ``lstm_text.LSTMTextEncoder`` (text_encoder.embedding, fwd_{l}, bwd_{l},
proj) instead of RoBERTa and the resizer.

``model.train()`` turns dropout on (``MODEL.STCAT.DROPOUT`` in the encoder
and decoders, ``HEAD_DROPOUT`` in the temp/action heads,
``TEXT_MODEL.DROPOUT`` in RoBERTa and the resizer); every keep mask is drawn
from the generator handed to ``forward`` (``model(batch, generator=g)``),
and a training forward that would draw a mask without one raises. In eval
mode nothing is drawn.

On a mesh (``models.parallelize``): under sequence parallelism
(``frame_shard``) the batch holds this rank's frames; the backbone and
input_proj run on them, and the features and masks are gathered on T before
the position encoding, so everything after runs on every frame, replicated
over the seq group. Under tensor parallelism the transformer layers split
their heads and FFN units over the model group.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config import Config
from ..core.batch import VideoBatch
from ..core.collectives import gather
from ..ops.misc import inverse_sigmoid
from .decoder import MLP, SpatialDecoder, TemplateGenerator, TimeDecoder
from .encoder import CrossModalEncoder, TimeEmbedding
from .lstm_text import LSTMTextEncoder
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
        d = self.d_model = s.HIDDEN
        dtype = self.compute_dtype = _dtype(c.TPU.COMPUTE_DTYPE)
        vb = c.MODEL.VISION_BACKBONE
        # the whole body is frozen with the backbone (VIS_BACKBONE_LR 0 too);
        # otherwise the stem and layer1
        frozen_stages = 4 if (vb.FREEZE or c.SOLVER.VIS_BACKBONE_LR <= 0) else 1
        self.vis_encoder = nn.ModuleList([
            _Backbone(build_resnet(vb.NAME, vb.DILATION, dtype=dtype, depths=vb.DEPTHS,
                                   conv_impl=c.TPU.CONV_IMPL, conv_stages=c.TPU.CONV_STAGES,
                                   frozen_stages=frozen_stages,
                                   remat_blocks=c.TPU.REMAT_BACKBONE,
                                   remat_stages=c.TPU.REMAT_STAGES)),
            PositionEncoding2D(vb.POS_ENC, d // 2),
        ])
        self.input_proj = nn.Conv2d(2048, d, 1)
        tm, lstm = c.MODEL.TEXT_MODEL, c.MODEL.LSTM
        if c.MODEL.USE_LSTM:
            self.text_encoder = LSTMTextEncoder(
                tm.VOCAB_SIZE, d, hidden_size=lstm.HIDDEN_SIZE, embed_dim=lstm.EMBED_DIM,
                num_layers=lstm.NUM_LAYERS, bidirectional=lstm.BIDIRECTIONAL,
                glove_path=lstm.GLOVE_PATH)
        else:
            self.text_encoder = TextEncoder(d, RobertaConfig(
                vocab_size=tm.VOCAB_SIZE, hidden_size=tm.HIDDEN, num_layers=tm.LAYERS,
                num_heads=tm.HEADS, intermediate_size=tm.INTERMEDIATE,
                max_position_embeddings=tm.MAX_POS, dropout=tm.DROPOUT,
            ), dtype, freeze_body=tm.FREEZE)
        impl = c.TPU.ATTENTION_IMPL
        self.ground_encoder = _GroundEncoder(CrossModalEncoder(
            d, s.HEADS, s.FFN_DIM, s.ENC_LAYERS, c.INPUT.MAX_VIDEO_LEN,
            s.USE_LEARN_TIME_EMBED, dtype, impl, dropout=s.DROPOUT,
        ))
        self.ground_decoder = _GroundDecoder(
            TemplateGenerator(d, s.QUERY_DIM),
            SpatialDecoder(d, s.HEADS, s.FFN_DIM, s.DEC_LAYERS, s.QUERY_DIM, s.DROPOUT,
                           s.FROM_SCRATCH, dtype, impl),
            TimeDecoder(d, s.HEADS, s.FFN_DIM, s.DEC_LAYERS, s.DROPOUT, dtype, impl),
            TimeEmbedding(c.INPUT.MAX_VIDEO_LEN + 1, d, s.USE_LEARN_TIME_EMBED),
        )
        self.bbox_embed = MLP(d, d, 4, 3)
        self.temp_embed = MLP(d, d, 2, 2, dropout=s.HEAD_DROPOUT)
        self.use_actioness = s.USE_ACTION
        if self.use_actioness:
            self.action_embed = MLP(d, d, 1, 2, dropout=s.HEAD_DROPOUT)
        self.use_attn = c.SOLVER.USE_ATTN
        self.use_aux_loss = c.SOLVER.USE_AUX_LOSS
        self.query_dim = s.QUERY_DIM
        self.mesh = None         # core.mesh.Mesh the model is laid out on (parallelize)
        self.frame_shard = None  # core.mesh.Shard of the frame axis (sequence parallel)

    # parameters that see only this rank's frames under sequence parallelism:
    # their gradients are summed over the seq group
    FRAME_LOCAL = ("vis_encoder.0.", "input_proj.")

    def forward(self, batch: VideoBatch,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
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
        if self.frame_shard is not None:  # every frame from here on
            group = self.frame_shard.group
            feats = gather(feats, group, 1)
            vis_valid, frame_valid = gather(vis_valid, group, 1), gather(frame_valid, group, 1)
            t = feats.shape[1]
        vis_pos = self.vis_encoder[1](vis_valid)

        text_feats, text_cls = self.text_encoder(batch.token_ids, batch.token_valid, generator)
        memory, mem_valid, frames_cls, videos_cls = self.ground_encoder.encoder(
            feats, vis_valid, vis_pos, text_feats, batch.token_valid.bool(), frame_valid,
            generator,
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
                                   frame_valid, self.bbox_embed, generator)
        time_hs, attn_weights = gd.temp_decoder(memory, mem_valid, mem_pos, content_query,
                                                query_time, frame_valid, generator)

        delta = self.bbox_embed(hs, generator)
        coords = torch.sigmoid(delta[..., : self.query_dim] + inverse_sigmoid(reference))
        sted = self.temp_embed(time_hs, generator)
        out: Dict[str, Any] = {"pred_boxes": coords[-1], "pred_sted": sted[-1]}
        if self.use_attn:
            out["weights"] = attn_weights[-1]
        if self.use_actioness:
            actioness = self.action_embed(time_hs, generator)
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
