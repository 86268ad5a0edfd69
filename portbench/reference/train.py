"""The reference's training arithmetic: the video grounding loss, the
parameter groups and their schedules, global-norm clipping, AdamW as the
optax chain computes it. A plain copy of what the recipes
state, written apart from the port."""

from __future__ import annotations

import math
from typing import Dict

import torch

from .model import NEG_INF

GROUPS = ("rest", "vis", "text", "temp")
BODY = "vis_encoder.0.body."


def cxcywh_to_xyxy(x):
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def giou(a, b):
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    wh = (torch.minimum(a[..., 2:], b[..., 2:]) - torch.maximum(a[..., :2], b[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    iou = inter / union.clamp(min=1e-12)
    wh = (torch.maximum(a[..., 2:], b[..., 2:]) - torch.minimum(a[..., :2], b[..., :2])).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-12)


def _in_span(bound, t):
    pos = torch.arange(t, device=bound.device)[None]
    return (pos >= bound[:, :1]) & (pos <= bound[:, 1:2])


def _gaussian(t, idx, sigma, mask):
    pos = torch.arange(t, dtype=torch.float32, device=idx.device)
    g = torch.exp(-((pos - idx[..., None].float()) ** 2) / (2.0 * sigma ** 2)) + 1e-6
    g = g * mask.float()
    return g / g.sum(-1, keepdim=True).clamp(min=1e-12)


def losses_of(out, tg, time_mask, num_boxes, sigma, eos_coef) -> Dict[str, torch.Tensor]:
    """One output layer's losses: boxes (L1, GIoU), the start / end KL, the
    guided attention and the actioness BCE."""
    b, t = time_mask.shape
    bm = tg["box_valid"].float()
    denom = b * num_boxes.clamp(min=1.0)
    pb = out["pred_boxes"]
    res = {"loss_bbox": ((pb - tg["boxes"]).abs().sum(-1) * bm).sum() / denom,
           "loss_giou": ((1 - giou(cxcywh_to_xyxy(pb), cxcywh_to_xyxy(tg["boxes"]))) * bm).sum()
           / denom}
    tm = time_mask.float()
    dur = tm.sum(-1).clamp(min=1.0)
    logits = torch.where(time_mask[:, :, None], out["pred_sted"],
                         torch.full_like(out["pred_sted"], NEG_INF))
    kl = 0
    for ch in (0, 1):
        target = _gaussian(t, tg["temp_bound"][:, ch], sigma, time_mask)
        pred = torch.softmax(logits[:, :, ch], 1)
        kl = kl + ((pred * torch.log((pred + 1e-6) / target.clamp(min=1e-12))) * tm).sum(-1)
    res["loss_sted"] = (kl / dur).mean()
    neg = time_mask & ~_in_span(tg["temp_bound"], t)
    att = -torch.log(1.0 - out["weights"] + 1e-6) * neg[:, :, None].float() * tm[:, None, :]
    res["loss_guided_attn"] = (att.sum((1, 2)) / (neg.sum(-1).float() + 1e-6)).mean()
    x = out["pred_actioness"].squeeze(-1)
    y = tg["actioness"].float()
    wgt = torch.where(_in_span(tg["temp_bound"], t), 1.0, eos_coef)
    bce = x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
    res["loss_actioness"] = ((bce * wgt * tm).sum(-1) / dur).mean()
    return res


def total_loss(out, tg, time_mask, solver: Dict, dec_layers: int, num_boxes=None) -> torch.Tensor:
    """The recipe's weighted sum over the last layer and every aux layer;
    ``num_boxes`` (default: this batch's true boxes per clip, at least 1)
    divides the box terms."""
    if num_boxes is None:
        num_boxes = (tg["box_valid"].sum().float() / time_mask.shape[0]).clamp(min=1.0)
    coef = {"loss_bbox": solver["BBOX_COEF"], "loss_giou": solver["GIOU_COEF"],
            "loss_sted": solver["TEMP_COEF"], "loss_actioness": solver["ACTIONESS_COEF"],
            "loss_guided_attn": solver["ATTN_COEF"]}
    layers = [out] + list(out["aux_outputs"])[: dec_layers - 1]
    total = 0
    for layer in layers:
        for k, v in losses_of(layer, tg, time_mask, num_boxes, solver["SIGMA"],
                              solver["EOS_COEF"]).items():
            total = total + coef[k] * v
    return total


def group_of(name: str) -> str:
    """The recipes' groups (backbone trainable, text not frozen): the stem
    and layer1 frozen, the rest of the body "vis", the text encoder "text",
    the time decoder "temp", the rest "rest"."""
    if name.startswith(BODY):
        rest = name[len(BODY):]
        return "frozen" if rest.startswith(("conv1.", "bn1.", "layer1.")) else "vis"
    if name.startswith("text_encoder."):
        return "text"
    if name.startswith("ground_decoder.temp_decoder."):
        return "temp"
    return "rest"


def lr_multiplier(schedule: str, step: int, total: int, warmup_prop: float, epochs: int,
                  drops) -> Dict[str, float]:
    warm = round(warmup_prop * total)
    per_epoch = max(1, round(total / epochs))

    def multistep(s):
        return 0.1 ** sum(d <= math.floor(s / per_epoch) for d in drops)

    def linear(s):
        if s < warm:
            return s / max(1.0, warm)
        return max(0.0, (total - s) / max(1.0, total - warm))

    def warm_multistep(s):
        return s / max(1.0, warm) if s < warm else multistep(s)

    if schedule == "multistep_with_warmup_all":
        return {g: warm_multistep(step) for g in GROUPS}
    if schedule == "multistep_with_warmup":
        return {"rest": multistep(step), "vis": multistep(step), "text": linear(step),
                "temp": linear(step)}
    if schedule == "linear_with_warmup":
        return {g: linear(step) for g in GROUPS}
    raise ValueError(schedule)


class Trainer:
    """The recipe's optimizer over a reference model: per-group AdamW
    (decay inside the update, as optax adds it), the global gradient norm
    clipped to MAX_GRAD_NORM, and the schedule's LR at the step count."""

    def __init__(self, model, solver: Dict, total_steps: int):
        self.model, self.s, self.total = model, solver, total_steps
        self.named = [(n, p) for n, p in model.named_parameters() if group_of(n) != "frozen"]
        for n, p in model.named_parameters():
            p.requires_grad_(group_of(n) != "frozen")
        self.m = {n: torch.zeros_like(p) for n, p in self.named}
        self.v = {n: torch.zeros_like(p) for n, p in self.named}
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in self.named}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        coef = min(1.0, self.s["MAX_GRAD_NORM"] / (float(norm) + 1e-6))
        s = self.s
        mult = lr_multiplier(s["SCHEDULE"]["TYPE"], self.count, self.total, s["WARMUP_PROP"],
                             s["MAX_EPOCH"], s["SCHEDULE"]["DROP_STEP"])
        base = {"rest": s["BASE_LR"], "vis": s["VIS_BACKBONE_LR"], "text": s["TEXT_LR"],
                "temp": s["TEMP_LR"]}
        self.count += 1
        t, b1, b2 = self.count, 0.9, 0.999
        for n, p in self.named:
            g = grads[n] * coef
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (self.m[n] / (1 - b1 ** t)) / (torch.sqrt(self.v[n] / (1 - b2 ** t)) + 1e-8)
            lr = base[group_of(n)] * mult[group_of(n)]
            p.add_(upd + s["WEIGHT_DECAY"] * p, alpha=-lr)

    def first_moments(self) -> Dict[str, torch.Tensor]:
        return self.m

