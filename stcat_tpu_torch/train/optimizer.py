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
    tests/test_train_step.py): AdamW (decoupled weight decay, computed as the
    optax chain computes it: ``AdamW`` below), Adam (L2 added to the
    gradient), RMSprop (alpha 0.99, eps 1e-8 outside the sqrt), SGD with
    momentum; frozen parameters are not registered, so they get no update
    and no weight decay; a trainable parameter the loss does not reach (the
    RoBERTa pooler) steps on a zero gradient, the one jax.grad gives it, so
    weight decay and the moments reach it as in the optax chain;
  * EMA of every parameter: e = e * decay + (1 - decay) * p.

On a model laid out with tensor parallelism every moment and EMA copy lives
on its parameter's part, and the clipped norm is the whole model's: the
squares of the sharded parameters' gradients are summed over the model
group, each replicated one counted once.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch import nn

from ..core.collectives import all_reduce
from ..core.mesh import MODEL_AXIS, tp_rule

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


class AdamW(torch.optim.Optimizer):
    """AdamW as the optax chain computes it (scale_by_adam, then
    add_decayed_weights, then the LR): the bias-corrected Adam direction
    m_hat / (sqrt(v_hat) + eps) plus WD x p, times -lr, added to p.
    torch.optim.AdamW first multiplies p by 1 - lr x WD, a factor fp32
    rounds to 1 whenever lr x WD < 3e-8 (the VidSTG recipe's 1e-9 to 1e-8),
    so it would train without weight decay; here the decay rides in the
    update, as in optax. The state per parameter is torch's AdamW's ("step",
    a CPU tensor, "exp_avg", "exp_avg_sq"), so a state saved with torch's
    AdamW (an earlier checkpoint) loads into it."""

    def __init__(self, params, weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, {"lr": 0.0, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st.update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                              exp_avg_sq=torch.zeros_like(p))
                st["step"] += 1
            grads = [p.grad for p in params]
            m, v = [st["exp_avg"] for st in states], [st["exp_avg_sq"] for st in states]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
            steps = [st["step"].item() for st in states]  # CPU tensors: no wait on the card
            # one temporary, as torch's AdamW: 1 / (sqrt(v_hat) + eps), then x m_hat
            update = torch._foreach_div(v, [1 - b2 ** t for t in steps])
            torch._foreach_sqrt_(update)
            torch._foreach_add_(update, group["eps"])
            torch._foreach_reciprocal_(update)
            torch._foreach_mul_(update, m)
            torch._foreach_div_(update, [1 - b1 ** t for t in steps])
            torch._foreach_add_(update, params, alpha=group["weight_decay"])
            torch._foreach_add_(params, update, alpha=-group["lr"])


def _core(name: str, groups: List[Dict], s) -> torch.optim.Optimizer:
    if name == "adamw":
        return AdamW(groups, weight_decay=s.WEIGHT_DECAY)
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
        # names in the core's parameter order (its state_dict's indices)
        by_id = {id(p): n for n, p in params.items()}
        self.param_names = [by_id[id(p)] for p in self.trainable]
        self.core = _core(s.OPTIMIZER, groups, s)
        self.max_grad_norm = s.MAX_GRAD_NORM
        self.lrs_at = current_lrs(cfg, num_training_steps)
        self.count = 0
        mesh = getattr(model, "mesh", None)
        self.model_group = None
        self.sharded = set()
        if mesh is not None and mesh.model_parallel > 1:
            self.model_group = mesh.group(MODEL_AXIS)
            self.sharded = {id(p) for n, p in params.items() if tp_rule(n, p.dim()) is not None}

    def zero_grad(self) -> None:
        self.core.zero_grad(set_to_none=True)
        for p in self.frozen:
            p.grad = None

    def _sq_norms(self, params) -> torch.Tensor:
        """[replicated, sharded] sums of squared gradients, the sharded one
        summed over the model group."""
        dev = params[0].device
        sums = torch.zeros(2, dtype=torch.float32, device=dev)
        for p in params:
            if p.grad is not None:
                sums[int(id(p) in self.sharded)] += p.grad.float().pow(2).sum()
        sharded = all_reduce(sums[1:].clone(), self.model_group)
        return torch.cat([sums[:1], sharded])

    def grad_norms(self) -> Dict[str, float]:
        """Each group's gradient norm over the whole model (a collective
        under tensor parallelism: every rank of the model group calls it)."""
        return {g["name"]: self._sq_norms(g["params"]).sum().sqrt().item()
                for g in self.core.param_groups}

    def step(self) -> None:
        for p in self.frozen:
            p.grad = None
        for p in self.trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.model_group is None:
            torch.nn.utils.clip_grad_norm_(self.trainable, self.max_grad_norm)
        else:
            total = self._sq_norms(self.trainable).sum().sqrt()
            coef = (self.max_grad_norm / (total + 1e-6)).clamp(max=1.0)
            torch._foreach_mul_([p.grad for p in self.trainable], coef)
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
        # a parameter that takes no gradient (an LSTM's input bias, trained
        # in states saved before it was fixed at 0) restarts from zero
        # moments, so its zero gradient leaves it where it is
        for p in self.trainable:
            if not p.requires_grad:
                self.core.state.pop(p, None)
        self.count = int(sd["count"])


def make_optimizer(cfg, model: nn.Module, num_training_steps: int) -> GroupedOptimizer:
    return GroupedOptimizer(cfg, model, num_training_steps)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float) -> None:
    """In place: ema[name] = ema[name] * decay + (1 - decay) * param."""
    for name, p in model.named_parameters():
        ema[name].mul_(decay).add_(p, alpha=1.0 - decay)
