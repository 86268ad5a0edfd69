"""The train step (the JAX package's train/step.py, one device).

    model = build_model(cfg, seed=0)                       # cuda by default
    opt = make_optimizer(cfg, model, num_training_steps)
    state = create_train_state(cfg, model, opt)
    step = make_train_step(cfg, model, opt)
    losses = step(state, raw_batch, targets, torch.Generator("cuda").manual_seed(s))

One step: the batch (a RawVideoBatch, rgb or yuv420, goes through
``ops/preprocess.py``; the host path's VideoBatch is used as it comes)
splits into TPU.GRAD_ACCUM microbatches of consecutive clips; each runs the
model in training mode and the loss, divided by GRAD_ACCUM, and adds its
gradients. All microbatches share ``num_boxes = max(GT boxes / B, 1)`` of the
whole batch, so the accumulated loss and gradients equal the full batch's,
and each draws its dropout masks from the step's generator in turn. Then one
optimizer update and the EMA. The model, optimizer and EMA are updated in
place; the step returns the loss and its terms, averaged over microbatches,
as device tensors. The mesh, tensor- and sequence-parallel branches of the
JAX step belong to the multi-GPU slice and raise here. ``make_eval_forward``
is the inference forward of evaluation and serving.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..core.batch import RawVideoBatch, VideoTargets, device_split_streams, to_device
from ..core.dist import get_world_size
from ..ops.misc import resolve_device
from ..ops.preprocess import preprocess
from .criterion import build_weight_dict, video_stg_loss
from .optimizer import GroupedOptimizer, ema_update


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optional[GroupedOptimizer]   # None: converted weights (cli/convert.py)
    ema: Optional[Dict[str, torch.Tensor]]  # parameter name -> EMA copy (MODEL.EMA)


def create_train_state(cfg, model: nn.Module, optimizer: GroupedOptimizer) -> TrainState:
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if cfg.MODEL.EMA else None)
    return TrainState(step=0, model=model, optimizer=optimizer, ema=ema)


def _rows(batch, start: int, stop: int):
    """Clips [start, stop) of every tensor field of a batch container."""
    upd = {f.name: getattr(batch, f.name)[start:stop] for f in dataclasses.fields(batch)
           if isinstance(getattr(batch, f.name), torch.Tensor)}
    return dataclasses.replace(batch, **upd)


def _check_cfg(cfg) -> int:
    t = cfg.TPU
    if t.MESH_DATA > 1 or t.MODEL_PARALLEL > 1 or t.SEQUENCE_PARALLEL:
        raise NotImplementedError(
            "data/tensor/sequence-parallel training belongs to the multi-GPU slice "
            "(ROADMAP.md, Queue A)")
    accum = int(t.GRAD_ACCUM)
    if accum < 1:
        raise ValueError(f"TPU.GRAD_ACCUM must be >= 1, got {accum}")
    return accum


def accumulate_grads(cfg, model: nn.Module, optimizer: GroupedOptimizer, batch,
                     targets: VideoTargets, generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
    """The gradient half of a step: the parameters' ``.grad`` are zeroed and
    then hold the batch loss's gradients, accumulated over TPU.GRAD_ACCUM
    microbatches; returns {"loss", "loss_*"} averaged over them (tensors).
    Batch and targets must be on the model's device."""
    accum = _check_cfg(cfg)
    b = targets.box_valid.shape[0]
    if b % accum:
        raise ValueError(f"TPU.GRAD_ACCUM={accum} does not divide batch size {b}")
    mb = b // accum
    s = cfg.SOLVER
    weight_dict = build_weight_dict(cfg)
    num_boxes = (targets.box_valid.sum().float() / b).clamp(min=1.0)
    model.train()
    optimizer.zero_grad()
    sums: Dict[str, torch.Tensor] = {}
    for i in range(accum):
        part = _rows(batch, i * mb, (i + 1) * mb)
        if isinstance(part, RawVideoBatch):
            part = preprocess(part, tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD))
        outputs = model(part, generator=generator)
        losses = video_stg_loss(outputs, _rows(targets, i * mb, (i + 1) * mb),
                                part.frame_valid, num_boxes, sigma=s.SIGMA,
                                eos_coef=s.EOS_COEF, use_attn=s.USE_ATTN,
                                use_actioness=cfg.MODEL.STCAT.USE_ACTION)
        total = sum(losses[k] * w for k, w in weight_dict.items() if k in losses)
        (total / accum).backward()
        for k, v in {"loss": total, **losses}.items():
            sums[k] = sums.get(k, 0.0) + v.detach() / accum
    return sums


def make_train_step(cfg, model: nn.Module, optimizer: GroupedOptimizer, device=None
                    ) -> Callable[[TrainState, object, VideoTargets, torch.Generator],
                                  Dict[str, torch.Tensor]]:
    """Returns step(state, batch, targets, generator) -> {"loss", "loss_*"},
    detached 0-d tensors on the device: the step never waits for the card,
    and the caller reads them when it needs them (the loop, every
    LOG_PERIOD steps)."""
    _check_cfg(cfg)
    dev = resolve_device(device)

    def step(state: TrainState, batch, targets: VideoTargets,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than this step")
        batch, targets = to_device(batch, dev), to_device(targets, dev)
        sums = accumulate_grads(cfg, model, optimizer, batch, targets, generator)
        optimizer.step()
        if state.ema is not None:
            ema_update(state.ema, model, cfg.MODEL.EMA_DECAY)
        state.step += 1
        return sums

    return step


def eval_device_split_active(cfg) -> bool:
    """Whether the eval forward splits the two test streams on the device
    (TPU.EVAL_DEVICE_SPLIT); single-process only."""
    return bool(cfg.TPU.EVAL_DEVICE_SPLIT) and get_world_size() == 1


def make_eval_forward(cfg, model: nn.Module, device_split: Optional[bool] = None
                      ) -> Callable[[object], Dict[str, torch.Tensor]]:
    """fwd(batch) -> the postprocess inputs {"pred_boxes", "pred_sted"} of a
    batch (raw, or the host path's VideoBatch) on the model's device, in
    inference mode. With the device split (``device_split`` None:
    ``eval_device_split_active(cfg)``) the batch arrives unsplit, is split
    into its even and odd streams and stacked here, and the split frame mask
    is returned as "frame_valid"; without it the batch arrives stacked
    (serve.py, the host split)."""
    split = eval_device_split_active(cfg) if device_split is None else bool(device_split)
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)

    def fwd(batch) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            if split:
                batch = device_split_streams(batch)
            if isinstance(batch, RawVideoBatch):
                batch = preprocess(batch, mean, std)
            out = model.eval()(batch)
            ret = {"pred_boxes": out["pred_boxes"], "pred_sted": out["pred_sted"]}
            if split:
                ret["frame_valid"] = batch.frame_valid
            return ret

    return fwd
