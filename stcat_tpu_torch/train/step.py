"""The train step (the JAX package's train/step.py).

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
as device tensors. ``make_eval_forward`` is the inference forward of
evaluation and serving.

On a mesh (a model built with ``build_model(..., mesh=)``) each rank holds
its part of the global batch (``core/mesh.py``): ``num_boxes`` is the global
batch's (GT boxes and clips summed over the data group before the first
microbatch), the frame fields of the targets are gathered on T under
sequence parallelism, and after the last microbatch the gradients of the
parameters that saw only this rank's frames are summed over the seq group
and then every gradient is averaged over the data group, in one flat
all-reduce each (the JAX step's single gradient pmean). The returned losses
are the global batch's means.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..core import trace
from ..core.batch import RawVideoBatch, VideoTargets, device_split_streams, to_device
from ..core.collectives import all_reduce, flat_all_reduce
from ..core.dist import get_world_size
from ..core.mesh import gather_frame_fields, gather_frames
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


def _check_cfg(cfg, model: nn.Module) -> int:
    accum = int(cfg.TPU.GRAD_ACCUM)
    if accum < 1:
        raise ValueError(f"TPU.GRAD_ACCUM must be >= 1, got {accum}")
    mesh = getattr(model, "mesh", None)
    if mesh is None and (get_world_size() > 1 or cfg.TPU.MODEL_PARALLEL > 1):
        raise ValueError("several processes or TPU.MODEL_PARALLEL > 1 train a model laid out "
                         "on a mesh: build_model(cfg, device, seed, mesh=mesh_from_config(cfg))")
    if mesh is not None and (mesh.model_parallel != max(1, cfg.TPU.MODEL_PARALLEL)
                             or mesh.sequence_parallel != bool(cfg.TPU.SEQUENCE_PARALLEL)):
        raise ValueError(f"the model's {mesh} does not match TPU.MODEL_PARALLEL="
                         f"{cfg.TPU.MODEL_PARALLEL}, SEQUENCE_PARALLEL={cfg.TPU.SEQUENCE_PARALLEL}")
    return accum


def reduce_gradients(model: nn.Module, optimizer: GroupedOptimizer) -> None:
    """The mesh's gradient rules, in place: sum the frame-local parameters'
    gradients over the seq group, then average every gradient over the data
    group (no-ops on groups this layout lacks)."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return
    named = [(n, p) for n, p in zip(optimizer.param_names, optimizer.trainable)
             if p.grad is not None]
    if mesh.seq_parallel > 1:
        flat_all_reduce([p.grad for n, p in named if n.startswith(model.FRAME_LOCAL)],
                        mesh.group(mesh.frame_axis))
    flat_all_reduce([p.grad for _, p in named], mesh.group(mesh.clip_axis),
                    scale=1.0 / mesh.data_parallel)


def accumulate_grads(cfg, model: nn.Module, optimizer: GroupedOptimizer, batch,
                     targets: VideoTargets, generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
    """The gradient half of a step: the parameters' ``.grad`` are zeroed and
    then hold the batch loss's gradients, accumulated over TPU.GRAD_ACCUM
    microbatches; returns {"loss", "loss_*"} averaged over them (tensors).
    Batch and targets must be on the model's device. On a mesh they are this
    rank's part of the global batch, and the gradients and losses on return
    are the global batch's (``reduce_gradients``)."""
    accum = _check_cfg(cfg, model)
    mesh = getattr(model, "mesh", None)
    b = targets.box_valid.shape[0]
    if b % accum:
        raise ValueError(f"TPU.GRAD_ACCUM={accum} does not divide batch size {b}")
    mb = b // accum
    s = cfg.SOLVER
    weight_dict = build_weight_dict(cfg)
    targets = gather_frame_fields(targets, mesh)
    time_mask = gather_frames(batch.frame_valid, mesh)
    # torch.full, not torch.tensor: a copy from host memory would wait for the card
    counts = torch.stack([targets.box_valid.sum().float(),
                          torch.full((), float(b), device=time_mask.device)])
    if mesh is not None:
        all_reduce(counts, mesh.group(mesh.clip_axis))
    num_boxes = (counts[0] / counts[1]).clamp(min=1.0)
    model.train()
    optimizer.zero_grad()
    sums: Dict[str, torch.Tensor] = {}
    for i in range(accum):
        part = _rows(batch, i * mb, (i + 1) * mb)
        if isinstance(part, RawVideoBatch):
            part = preprocess(part, tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD))
        outputs = model(part, generator=generator)
        losses = video_stg_loss(outputs, _rows(targets, i * mb, (i + 1) * mb),
                                time_mask[i * mb:(i + 1) * mb], num_boxes, sigma=s.SIGMA,
                                eos_coef=s.EOS_COEF, use_attn=s.USE_ATTN,
                                use_actioness=cfg.MODEL.STCAT.USE_ACTION)
        total = sum(losses[k] * w for k, w in weight_dict.items() if k in losses)
        (total / accum).backward()
        for k, v in {"loss": total, **losses}.items():
            sums[k] = sums.get(k, 0.0) + v.detach() / accum
    reduce_gradients(model, optimizer)
    if mesh is not None and mesh.data_parallel > 1:
        stacked = all_reduce(torch.stack(list(sums.values())), mesh.group(mesh.clip_axis))
        sums = dict(zip(sums, (stacked / mesh.data_parallel).unbind(0)))
    return sums


def make_train_step(cfg, model: nn.Module, optimizer: GroupedOptimizer, device=None
                    ) -> Callable[[TrainState, object, VideoTargets, torch.Generator],
                                  Dict[str, torch.Tensor]]:
    """Returns step(state, batch, targets, generator) -> {"loss", "loss_*"},
    detached 0-d tensors on the device: the step never waits for the card,
    and the caller reads them when it needs them (the loop, every
    LOG_PERIOD steps). With the recorder on (``core/trace.py``) a step
    records ``train.grads`` (``accumulate_grads``: forward, loss, backward,
    gradient reduction), ``train.optimizer`` and ``train.ema``: host time,
    the device's side of which runs behind it."""
    _check_cfg(cfg, model)
    dev = resolve_device(device)

    def step(state: TrainState, batch, targets: VideoTargets,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than this step")
        batch, targets = to_device(batch, dev), to_device(targets, dev)
        with trace.span("train.grads"):
            sums = accumulate_grads(cfg, model, optimizer, batch, targets, generator)
        with trace.span("train.optimizer"):
            optimizer.step()
        if state.ema is not None:
            with trace.span("train.ema"):
                ema_update(state.ema, model, cfg.MODEL.EMA_DECAY)
        state.step += 1
        return sums

    return step


def eval_device_split_active(cfg) -> bool:
    """Whether the eval forward splits the two test streams on the device
    (TPU.EVAL_DEVICE_SPLIT); single-process only, as in the JAX package: on
    several processes the batches arrive stacked on the host."""
    return bool(cfg.TPU.EVAL_DEVICE_SPLIT) and get_world_size() == 1


def make_eval_forward(cfg, model: nn.Module, device_split: Optional[bool] = None
                      ) -> Callable[[object], Dict[str, torch.Tensor]]:
    """fwd(batch) -> the postprocess inputs {"pred_boxes", "pred_sted"} of a
    batch (raw, or the host path's VideoBatch) on the model's device, in
    inference mode. With the device split (``device_split`` None:
    ``eval_device_split_active(cfg)``) the batch arrives unsplit and is split
    into its even and odd streams and stacked here; without it the batch
    arrives stacked (serve.py, the host split). "frame_valid" is the frame
    mask of the predictions' rows: the split one, or, on a sequence-parallel
    mesh, the rank's frames' gathered back to every frame."""
    split = eval_device_split_active(cfg) if device_split is None else bool(device_split)
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
    mesh = getattr(model, "mesh", None)

    def fwd(batch) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            if split:
                batch = device_split_streams(batch)
            if isinstance(batch, RawVideoBatch):
                batch = preprocess(batch, mean, std)
            out = model.eval()(batch)
            return {"pred_boxes": out["pred_boxes"], "pred_sted": out["pred_sted"],
                    "frame_valid": gather_frames(batch.frame_valid, mesh)}

    return fwd
