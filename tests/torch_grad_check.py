"""The tiny model's training-gradient check against a float64 reference
(torch and numpy only, so the card machine runs it without JAX).

Every route of one training forward+backward (the CPU's plain versions in
fp32, the card's plain versions in fp32, the card's kernels in fp32) is held
to the same gradients computed in float64 on the CPU with the plain
versions (``Float64``). Per gradient tensor, the relative L2 error of the
kernel route must stay within ``MULTIPLE`` times the larger of the two plain
routes' errors plus ``FLOOR``: the kernels may be as far from the exact
gradient as an fp32 plain computation is, not further.

Also here: the port's fresh-weight draw before it drew the JAX package's
distributions (``untruncated_init``: every matrix and convolution from an
untruncated normal of variance 1 / fan_in), kept to read the checks at both
draws, and a planted K2 fault (``planted_k2_fault``) that a check must catch.
"""

from __future__ import annotations

import collections
import contextlib
import math

import numpy as np
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from stcat_tpu_torch.kernels import attention as kattn

# the kernel route's error to the float64 reference, per gradient tensor,
# may be MULTIPLE x the larger plain route's plus FLOOR. Readings on the
# H100 (scripts/torch_grad_readings.py): at seed 0 of either draw the
# kernels' error is at most 1.53x the larger plain one where it exceeds
# 1e-6, and every tensor is within 4.8e-5; at seed 6 of the JAX draw the
# kernels alone read 1.35e-4 on every trainable backbone convolution (one
# rounding on the other side of a kink upstream of them: the CPU's own fp32
# route reads up to 3.7e-2 there on another CPU), which FLOOR admits. A 1%
# error in one K2 call's dk reads 9.5e-3 on the leaves it feeds.
MULTIPLE, FLOOR = 2.0, 5e-4


def tiny_cfg(extra=()):
    """The port's config at tiny widths, fp32, every kernel route on."""
    from stcat_tpu_torch.config import default_config, merge_from_list

    return merge_from_list(default_config(), [
        "MODEL.VISION_BACKBONE.NAME", "resnet50", "MODEL.VISION_BACKBONE.DEPTHS", "[1,1,1,1]",
        "MODEL.STCAT.ENC_LAYERS", 2, "MODEL.STCAT.DEC_LAYERS", 2, "MODEL.STCAT.HIDDEN", 64,
        "MODEL.STCAT.HEADS", 4, "MODEL.STCAT.FFN_DIM", 128, "INPUT.MAX_VIDEO_LEN", 32,
        "MODEL.TEXT_MODEL.VOCAB_SIZE", 128, "MODEL.TEXT_MODEL.HIDDEN", 32,
        "MODEL.TEXT_MODEL.LAYERS", 2, "MODEL.TEXT_MODEL.HEADS", 2,
        "MODEL.TEXT_MODEL.INTERMEDIATE", 64, "MODEL.TEXT_MODEL.MAX_POS", 64,
        "TPU.COMPUTE_DTYPE", "float32", "TPU.CONV_IMPL", "pallas", "TPU.CONV_STAGES", "[1,2,3,4]",
    ] + list(extra))


def train_cfg():
    """The tiny model with a trainable fused block in layer2, no dropout,
    two microbatches."""
    return tiny_cfg(["MODEL.VISION_BACKBONE.DEPTHS", "[1,2,1,1]", "MODEL.STCAT.DROPOUT", 0.0,
                     "MODEL.STCAT.HEAD_DROPOUT", 0.0, "MODEL.TEXT_MODEL.DROPOUT", 0.0,
                     "TPU.GRAD_ACCUM", 2])


def train_arrays():
    """(batch, targets) as numpy arrays: two 6-frame 64x64 clips, one with two
    padded frames, each with a span and boxes."""
    rng = np.random.RandomState(4)
    b, t, h, w, l = 2, 6, 64, 64, 7
    frame_valid = np.ones((b, t), bool)
    frame_valid[1, 4:] = False
    actioness = np.zeros((b, t), np.float32)
    actioness[0, 1:4] = 1.0
    actioness[1, 2] = 1.0
    box_valid = actioness.astype(bool)
    batch = dict(frames=rng.randn(b, t, h, w, 3).astype(np.float32), frame_valid=frame_valid,
                 pixel_valid=np.ones((b, t, h, w), bool), token_ids=rng.randint(3, 100, (b, l)),
                 token_valid=np.ones((b, l), bool))
    targets = dict(boxes=rng.uniform(0.2, 0.6, (b, t, 4)).astype(np.float32) * box_valid[..., None],
                   box_valid=box_valid, actioness=actioness,
                   temp_bound=np.asarray([[1, 3], [2, 2]], np.int32))
    return batch, targets


class Float64(TorchDispatchMode):
    """Inside, the port computes in float64 where it names float32: every
    float32 dtype an op is given (``.float()``, ``.to(compute dtype)``, a
    ``dtype=``) is float64, in the forward, in the backward (autograd
    Functions' own, the bottleneck's recompute) and in checkpoint
    recomputes alike, since a dispatch mode reaches all three. The
    parameters, buffers and inputs must be float64 already."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        sub = lambda a: torch.float64 if a is torch.float32 else a  # noqa: E731
        return func(*tree_map(sub, args), **tree_map(sub, kwargs or {}))


class Float32Ops(TorchDispatchMode):
    """Counts the aten ops, forward and backward, that return a float32
    tensor."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.float32 for t in tree_leaves(out)):
            self.ops[str(func)] += 1
        return out


@torch.no_grad()
def untruncated_init(model: nn.Module, generator: torch.Generator) -> None:
    """The port's fresh-weight draw before it drew the JAX package's
    distributions: every matrix, convolution and attention input projection
    from an untruncated normal of std 1 / sqrt(fan_in), the rest as
    ``init_parameters`` draws it (a model without an LSTM text encoder)."""
    from stcat_tpu_torch.models import MultiHeadAttention
    from stcat_tpu_torch.models.position2d import PositionEncoding2D

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for name, mod in model.named_modules():
        if isinstance(mod, MultiHeadAttention):
            normal_(mod.in_proj_weight, 1.0 / math.sqrt(mod.d_model))
            mod.in_proj_bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            normal_(mod.weight, 1.0 / math.sqrt(mod.weight[0].numel()))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, PositionEncoding2D) and mod.kind == "learned":
            for table in (mod.row_embed.weight, mod.col_embed.weight):
                table.copy_(torch.rand(table.shape, generator=generator))
        elif isinstance(mod, nn.Embedding) and not name.endswith(("row_embed", "col_embed")):
            std = 1.0 / math.sqrt(mod.embedding_dim) if name.startswith("text_encoder") else 1.0
            normal_(mod.weight, std)


def fresh_model(cfg, device, draw: str, seed: int = 0):
    """build_model's model from ``seed``, with the JAX package's
    distributions (draw "jax") or the earlier untruncated draw."""
    from stcat_tpu_torch.models import STCATNet, build_model

    if draw == "jax":
        return build_model(cfg, device=device, seed=seed)
    model = STCATNet(cfg)
    untruncated_init(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


@contextlib.contextmanager
def planted_k2_fault(call: int, kind: str = "scale", factor: float = 1.01, every: int = 0):
    """Plants a fault in one attention backward call (K2 on the card, its
    plain version on the CPU), the ``call``-th from the context's start (and
    every ``every`` calls after it, to hit one call site in each microbatch):
    its dk scaled by ``factor`` ("scale") or its last 64-key tile zeroed
    ("tile"). Yields the list of the calls it changed (k's shape)."""
    launch = kattn.flash_attention_bwd
    count, planted = [0], []

    def faulty(q, k, v, bias, g):
        dq, dk, dv, dbias = launch(q, k, v, bias, g)
        i = count[0]
        count[0] += 1
        if i == call or (every and i > call and (i - call) % every == 0):
            planted.append(tuple(k.shape))
            if kind == "scale":
                dk = dk * factor
            else:
                dk = dk.clone()
                dk[:, 64 * ((k.shape[1] - 1) // 64):] = 0
        return dq, dk, dv, dbias

    kattn.flash_attention_bwd = faulty
    try:
        yield planted
    finally:
        kattn.flash_attention_bwd = launch


def training_grads(cfg, model, batch: dict, targets: dict, dtype=torch.float32):
    """One forward+backward of ``accumulate_grads`` on the model's device:
    (loss, {name: gradient or None} on the CPU in float64). ``dtype``
    float64 runs it under ``Float64`` on a float64 copy of the inputs (the
    model must be ``.double()``)."""
    from stcat_tpu_torch.core.batch import VideoBatch, VideoTargets
    from stcat_tpu_torch.train.optimizer import make_optimizer
    from stcat_tpu_torch.train.step import accumulate_grads

    device = next(model.parameters()).device

    def place(arrays):
        return {k: torch.from_numpy(v.astype(np.float64) if dtype == torch.float64
                                    and v.dtype == np.float32 else v).to(device)
                for k, v in arrays.items()}

    opt = make_optimizer(cfg, model, num_training_steps=10)
    with Float64() if dtype == torch.float64 else contextlib.nullcontext():
        losses = accumulate_grads(cfg, model, opt, VideoBatch(**place(batch)),
                                  VideoTargets(**place(targets)))
    return (losses["loss"].item(),
            {n: None if p.grad is None else p.grad.detach().double().cpu()
             for n, p in model.named_parameters()})


def rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||a - ref|| / ||ref|| in float64; 0 where both are 0."""
    diff, norm = (a.double() - ref.double()).norm().item(), ref.double().norm().item()
    return 0.0 if diff == 0 else diff / norm if norm > 0 else math.inf


def route_errors(grads: dict, reference: dict) -> dict:
    """{name: relative L2 error to the reference} over the tensors with a
    gradient."""
    return {n: rel_l2(g, reference[n]) for n, g in grads.items() if g is not None}


def check_failures(kernel: dict, plains, multiple: float = MULTIPLE, floor: float = FLOOR):
    """The tensors whose kernel-route error exceeds ``multiple`` x the
    largest plain route's error plus ``floor``, as (name, kernel error,
    plain error) from the worst."""
    out = []
    for n, e in kernel.items():
        p = max(errs[n] for errs in plains)
        if not e <= multiple * p + floor:
            out.append((n, e, p))
    return sorted(out, key=lambda x: -x[1] / (multiple * x[2] + floor))
