"""Optimizer: four LR groups and a frozen set, per-step schedules, gradient
clipping and EMA (the JAX package's train/optimizer.py).

  * groups by parameter name: the backbone body ("vis"; its stem and layer1
    always "frozen", the whole body when the backbone is frozen), the text
    encoder ("text"; its RoBERTa body "frozen" under TEXT_MODEL.FREEZE, the
    resizer staying "text"), the time decoder ("temp"), everything else
    ("rest");
  * each step: frozen gradients dropped, the global gradient norm of the
    trainable parameters clipped to SOLVER.MAX_GRAD_NORM, each group's LR set
    to base LR x its schedule multiplier at the step count (the first step
    uses the multiplier of step 0), then the optimizer core;
  * cores, torch semantics (the JAX package's optax chain is pinned to them by
    tests/test_train_step.py): AdamW (decoupled weight decay), Adam (L2 added
    to the gradient), RMSprop (alpha 0.99, eps 1e-8 outside the sqrt), SGD
    with momentum; frozen parameters are not registered, so they get no
    update and no weight decay;
  * EMA of every parameter: e = e * decay + (1 - decay) * p.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch import nn

GROUPS = ("rest", "vis", "text", "temp")

_BODY = "vis_encoder.0.body."


def label_params(cfg, model: nn.Module) -> Dict[str, str]:
    """Parameter name -> group ("rest", "vis", "text", "temp" or "frozen")."""
    vis_trainable = (not cfg.MODEL.VISION_BACKBONE.FREEZE) and cfg.SOLVER.VIS_BACKBONE_LR > 0
    text_trainable = not cfg.MODEL.TEXT_MODEL.FREEZE

    def label_of(name: str) -> str:
        if name.startswith(_BODY):
            if not vis_trainable or name[len(_BODY):].startswith(("conv1.", "bn1.", "layer1.")):
                return "frozen"
            return "vis"
        if name.startswith("text_encoder."):
            if not text_trainable and name.startswith("text_encoder.body."):
                return "frozen"
            return "text"
        if name.startswith("ground_decoder.temp_decoder."):
            return "temp"
        return "rest"

    return {name: label_of(name) for name, _ in model.named_parameters()}


def make_gamma_fns(cfg, num_training_steps: int) -> Dict[str, Callable[[int], float]]:
    """Schedule multiplier per group: {group: fn(step) -> float}."""
    s = cfg.SOLVER
    num_warmup = round(s.WARMUP_PROP * num_training_steps)
    iter_per_epoch = max(1, round(num_training_steps / s.MAX_EPOCH))
    drops = tuple(s.SCHEDULE.DROP_STEP)

    def multistep(step: int) -> float:
        epoch = math.floor(step / iter_per_epoch)
        return 0.1 ** sum(d <= epoch for d in drops)

    def warmup_then_linear_decay(step: int) -> float:
        if step < num_warmup:
            return step / max(1.0, num_warmup)
        return max(0.0, (num_training_steps - step) / max(1.0, num_training_steps - num_warmup))

    def warmup_then_multistep(step: int) -> float:
        return step / max(1.0, num_warmup) if step < num_warmup else multistep(step)

    stype = s.SCHEDULE.TYPE
    if stype == "multistep_with_warmup":
        return {"rest": multistep, "vis": multistep,
                "text": warmup_then_linear_decay, "temp": warmup_then_linear_decay}
    if stype == "multistep_with_warmup_all":
        return {g: warmup_then_multistep for g in GROUPS}
    if stype == "linear_with_warmup":
        return {g: warmup_then_linear_decay for g in GROUPS}
    raise ValueError(f"Unsupported schedule type: {stype}")


def current_lrs(cfg, num_training_steps: int) -> Callable[[int], Dict[str, float]]:
    """fn(step) -> {group: learning rate} for the four trainable groups."""
    gammas = make_gamma_fns(cfg, num_training_steps)
    s = cfg.SOLVER
    base = {"rest": s.BASE_LR, "vis": s.VIS_BACKBONE_LR, "text": s.TEXT_LR, "temp": s.TEMP_LR}
    return lambda step: {g: base[g] * gammas[g](step) for g in GROUPS}


def _core(name: str, groups: List[Dict], s) -> torch.optim.Optimizer:
    if name == "adamw":
        return torch.optim.AdamW(groups, weight_decay=s.WEIGHT_DECAY)
    if name == "adam":
        return torch.optim.Adam(groups, weight_decay=s.WEIGHT_DECAY)
    if name == "rmsprop":
        return torch.optim.RMSprop(groups, alpha=0.99, eps=1e-8, weight_decay=s.WEIGHT_DECAY)
    if name == "sgd":
        return torch.optim.SGD(groups, lr=0.0, momentum=s.MOMENTUM,
                               weight_decay=s.WEIGHT_DECAY)
    raise ValueError(f"unsupported optimizer {name}")


class GroupedOptimizer:
    """The step that the JAX package's optax chain takes, over a model's
    parameters: ``zero_grad()``, backward, ``step()``."""

    def __init__(self, cfg, model: nn.Module, num_training_steps: int):
        s = cfg.SOLVER
        self.labels = label_params(cfg, model)
        params = dict(model.named_parameters())
        self.frozen = [p for n, p in params.items() if self.labels[n] == "frozen"]
        groups = [{"params": [p for n, p in params.items() if self.labels[n] == g],
                   "lr": 0.0, "name": g} for g in GROUPS]
        groups = [g for g in groups if g["params"]]
        self.trainable = [p for g in groups for p in g["params"]]
        self.core = _core(s.OPTIMIZER, groups, s)
        self.max_grad_norm = s.MAX_GRAD_NORM
        self.lrs_at = current_lrs(cfg, num_training_steps)
        self.count = 0

    def zero_grad(self) -> None:
        self.core.zero_grad(set_to_none=True)
        for p in self.frozen:
            p.grad = None

    def step(self) -> None:
        for p in self.frozen:
            p.grad = None
        torch.nn.utils.clip_grad_norm_(self.trainable, self.max_grad_norm)
        lrs = self.lrs_at(self.count)
        for group in self.core.param_groups:
            group["lr"] = lrs[group["name"]]
        self.core.step()
        self.count += 1

    def state_dict(self) -> Dict:
        """The core's state (moments, per-parameter step), the schedule
        position ``count`` and the group names, for a checkpoint."""
        return {"core": self.core.state_dict(), "count": self.count,
                "groups": [g["name"] for g in self.core.param_groups]}

    def load_state_dict(self, sd: Dict) -> None:
        groups = [g["name"] for g in self.core.param_groups]
        if list(sd["groups"]) != groups:
            raise ValueError(f"optimizer groups {list(sd['groups'])} in the state, "
                             f"{groups} in this optimizer")
        self.core.load_state_dict(sd["core"])
        self.count = int(sd["count"])


def make_optimizer(cfg, model: nn.Module, num_training_steps: int) -> GroupedOptimizer:
    return GroupedOptimizer(cfg, model, num_training_steps)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float) -> None:
    """In place: ema[name] = ema[name] * decay + (1 - decay) * param."""
    for name, p in model.named_parameters():
        ema[name].mul_(decay).add_(p, alpha=1.0 - decay)
