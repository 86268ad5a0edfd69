"""Collectives over a process group, and the autograd Functions that carry
tensor- and sequence-parallel activations across one.

    copy_to(x, group)      identity forward, all-reduce of the gradient
    reduce_from(x, group)  all-reduce forward, identity backward
    gather(x, group, dim)  all-gather along ``dim`` forward, this rank's
                           slice of the gradient backward

``copy_to`` enters a column-parallel region and ``reduce_from`` leaves a
row-parallel one (Megatron's f and g). ``gather`` hands every rank of the
group the whole tensor for work that then runs replicated there: each rank
computes the whole gradient of it, so the backward keeps its own slice and
sums nothing. A ``group`` of None is no group: each function is then the
identity.

gloo runs only broadcast and all_reduce on CUDA tensors, so with a gloo group
every collective on a card's tensor goes through host memory (a copy each
way), chosen from the group's backend name; NCCL groups take card tensors as
they are. ``TRAFFIC`` counts the calls and the bytes each collective moved
(a tensor's bytes per call, whatever the algorithm sends).
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, List

import torch
import torch.distributed as td

_log = logging.getLogger("stcat_tpu_torch")


class Traffic:
    """Calls and bytes per collective since the last ``reset()``."""

    def __init__(self):
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def add(self, op: str, t: torch.Tensor) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        self.bytes[op] = self.bytes.get(op, 0) + t.numel() * t.element_size()

    def summary(self) -> Dict[str, Dict[str, int]]:
        return {op: {"calls": self.calls[op], "bytes": self.bytes[op]} for op in self.calls}


TRAFFIC = Traffic()


@functools.cache
def _note_staging() -> None:
    _log.info("gloo process group: card tensors go through host memory in every collective")


def staged(t: torch.Tensor, group) -> bool:
    """Whether a collective on ``t`` over ``group`` goes through host memory:
    a card tensor on a gloo group (logged once per process)."""
    if not t.is_cuda or td.get_backend(group) != "gloo":
        return False
    _note_staging()
    return True


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` over ``group``; returns ``t``."""
    if group is None:
        return t
    TRAFFIC.add("all_reduce", t)
    if staged(t, group):
        host = t.cpu()
        td.all_reduce(host, group=group)
        t.copy_(host)
    else:
        td.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors, in group-rank order, concatenated along ``dim``."""
    if group is None:
        return t
    TRAFFIC.add("all_gather", t)
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    src = src.cpu() if staged(src, group) else src
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(td.get_world_size(group))]
    td.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim).to(t.device)
    return out.bool() if t.dtype == torch.bool else out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.index, ctx.width = dim, td.get_rank(group), x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width).contiguous(), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Differentiable all-gather along ``dim`` (identity without a group)."""
    if group is None:
        return x
    if not x.requires_grad:
        return all_gather(x, group, dim)
    return _Gather.apply(x, group, dim)


def flat_all_reduce(tensors: List[torch.Tensor], group, scale: float = 1.0) -> None:
    """Sum every tensor over ``group`` through one flat buffer (one
    collective), each scaled by ``scale`` afterwards; in place."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce(flat, group)
    if scale != 1.0:
        flat.mul_(scale)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
