"""VideoSTG loss over fixed-shape masked batches (the JAX package's
train/criterion.py).

One query per frame aligns with that frame's GT, so there is no matching;
every loss is a mask-weighted reduction over the padded [B, T] axes. Each
clip is reduced with its own duration as denominator and the clips are
averaged, and box sums are divided by ``num_boxes = max(GT boxes / B, 1)``
over the whole batch: the global-batch form of the reference's
per-device losses averaged over devices.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.batch import VideoTargets
from ..ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou_pairwise
from ..ops.misc import NEG_INF
from ..ops.sted import gaussian_sted_target


def _in_span(targets: VideoTargets, t: int) -> torch.Tensor:
    pos = torch.arange(t, device=targets.temp_bound.device)[None, :]
    return (pos >= targets.temp_bound[:, :1]) & (pos <= targets.temp_bound[:, 1:2])


def _loss_boxes(pred_boxes, targets: VideoTargets, num_boxes, b):
    """L1 + GIoU on the frames of the GT span, summed over the batch and
    divided by B * num_boxes."""
    bm = targets.box_valid.float()
    denom = b * num_boxes.clamp(min=1.0)
    loss_bbox = ((pred_boxes - targets.boxes).abs().sum(-1) * bm).sum() / denom
    giou = generalized_box_iou_pairwise(box_cxcywh_to_xyxy(pred_boxes),
                                        box_cxcywh_to_xyxy(targets.boxes))
    loss_giou = ((1.0 - giou) * bm).sum() / denom
    return {"loss_bbox": loss_bbox, "loss_giou": loss_giou}


def _loss_sted(pred_sted, targets: VideoTargets, time_mask, sigma):
    """KL(pred || gaussian at the GT start / end), per clip over its own
    duration, averaged over the batch."""
    eps = 1e-6
    t = pred_sted.shape[1]
    tm = time_mask.float()
    durations = tm.sum(-1).clamp(min=1.0)
    logits = torch.where(time_mask[:, :, None], pred_sted, torch.full_like(pred_sted, NEG_INF))

    def one(boundary_idx, channel):
        target = gaussian_sted_target(t, boundary_idx, sigma, time_mask=time_mask)
        pred = torch.softmax(logits[:, :, channel], dim=1)
        kl = pred * torch.log((pred + eps) / target.clamp(min=1e-12))
        return (kl * tm).sum(-1)

    per_clip = one(targets.temp_bound[:, 0], 0) + one(targets.temp_bound[:, 1], 1)
    return {"loss_sted": (per_clip / durations).mean()}


def _loss_guided_attn(weights, targets: VideoTargets, time_mask):
    """-log(1 - w) of the temporal self-attention rows outside the GT span
    (valid columns only), per clip over its negative-row count."""
    eps = 1e-6
    negative = time_mask & ~_in_span(targets, time_mask.shape[1])
    loss = -torch.log(1.0 - weights + eps)
    loss = loss * negative[:, :, None].float() * time_mask[:, None, :].float()
    nb_neg = negative.sum(-1).float() + eps
    return {"loss_guided_attn": (loss.sum((1, 2)) / nb_neg).mean()}


def _loss_actioness(pred_actioness, targets: VideoTargets, time_mask, eos_coef):
    """Per-frame BCE, weighted eos_coef outside the GT span, per clip over its
    duration."""
    logits = pred_actioness.squeeze(-1)
    labels = targets.actioness.float()
    weight = torch.where(_in_span(targets, logits.shape[1]), 1.0, eos_coef)
    tm = time_mask.float()
    durations = tm.sum(-1).clamp(min=1.0)
    bce = logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return {"loss_actioness": ((bce * weight * tm).sum(-1) / durations).mean()}


def video_stg_loss(outputs: Dict, targets: VideoTargets, time_mask: torch.Tensor,
                   num_boxes: torch.Tensor, sigma: float = 2.0, eos_coef: float = 0.1,
                   use_attn: bool = True, use_actioness: bool = True) -> Dict[str, torch.Tensor]:
    """Every loss of ``outputs`` and of each aux layer (suffixed ``_i``).

    outputs: the model's dict (pred_boxes [B, T, 4] normalized cxcywh,
    pred_sted [B, T, 2], weights [B, T, T], pred_actioness [B, T, 1],
    aux_outputs); time_mask [B, T] bool valid frames; num_boxes a scalar
    tensor, max(GT boxes in the whole batch / B, 1).
    """
    b = time_mask.shape[0]

    def single(out):
        losses = {}
        losses.update(_loss_boxes(out["pred_boxes"], targets, num_boxes, b))
        losses.update(_loss_sted(out["pred_sted"], targets, time_mask, sigma))
        if use_attn and "weights" in out:
            losses.update(_loss_guided_attn(out["weights"], targets, time_mask))
        if use_actioness and "pred_actioness" in out:
            losses.update(_loss_actioness(out["pred_actioness"], targets, time_mask, eos_coef))
        return losses

    losses = single(outputs)
    for i, aux in enumerate(outputs.get("aux_outputs", [])):
        for k, v in single(aux).items():
            losses[f"{k}_{i}"] = v
    return losses


def build_weight_dict(cfg) -> Dict[str, float]:
    """Loss coefficients, aux replicas included."""
    s = cfg.SOLVER
    wd = {"loss_bbox": s.BBOX_COEF, "loss_giou": s.GIOU_COEF, "loss_sted": s.TEMP_COEF}
    if cfg.MODEL.STCAT.USE_ACTION:
        wd["loss_actioness"] = s.ACTIONESS_COEF
    if s.USE_ATTN:
        wd["loss_guided_attn"] = s.ATTN_COEF
    if s.USE_AUX_LOSS:
        aux = {}
        for i in range(cfg.MODEL.STCAT.DEC_LAYERS - 1):
            aux.update({f"{k}_{i}": v for k, v in wd.items()})
        wd.update(aux)
    return wd
