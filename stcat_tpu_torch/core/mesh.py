"""The device mesh over torch.distributed ranks, its batch layout and the
tensor-parallel partition rules (the JAX package's core/mesh.py).

One process per device. ``make_mesh`` lays the ranks out as the JAX mesh lays
out devices: axis "data" outermost, then "seq", then "model" innermost, so a
model group is a run of adjacent ranks; rank r sits at
``np.unravel_index(r, shape)``. Each axis longer than one gets one process
group per line of ranks along it (a world of one uses the world group, so
that its collectives still run through the backend). The backend of those
groups is the world's, which the caller chose (``core/dist.py``): nccl when
every rank has its own card, gloo on the CPU and for ranks sharing a card.

Roles of the axes:
  * clips: "data" shards the global batch's clips (one data rank's clips are
    ``BATCH_SIZE x world / data`` of them, the JAX global batch of
    ``BATCH_SIZE x mesh size`` cut over "data"); gradients are averaged over it;
  * frames (TPU.SEQUENCE_PARALLEL): "seq", or "data" on a mesh without a seq
    axis (one long clip over the ranks, clips replicated), cuts the frame
    axis of the frame fields; the backbone and input_proj run on the rank's
    frames, their features are gathered on T, and the rest runs replicated;
  * model (TPU.MODEL_PARALLEL): attention heads and FFN hidden units are
    sharded Megatron-style (``tp_rule``); replicated weights stay whole.
Ranks of one model or seq group hold the same clips and compute the same
predictions and losses.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as td

from . import collectives
from .dist import get_rank, get_world_size

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"

# fields carrying a [B, T, ...] frame axis (VideoBatch / RawVideoBatch /
# VideoTargets)
_FRAME_AXIS_FIELDS = frozenset(
    {"frames", "frames_u8", "frames_y", "frames_cbcr", "frame_valid",
     "pixel_valid", "boxes", "box_valid", "actioness"}
)


def mesh_shape(num_devices: int, model_parallel: int = 1, seq_parallel: int = 1
               ) -> Dict[str, int]:
    """{axis: size}, outermost first: (data,), (data, model), (data, seq) or
    (data, seq, model), as the JAX ``make_mesh`` builds them."""
    mp, sp, n = max(1, model_parallel), max(1, seq_parallel), num_devices
    if mp == 1 and sp == 1:
        return {DATA_AXIS: n}
    if n % (mp * sp):
        raise ValueError(
            f"{n} devices not divisible by model_parallel={mp} x seq_parallel={sp}"
        )
    shape = {DATA_AXIS: n // (mp * sp)}
    if sp > 1:
        shape[SEQ_AXIS] = sp
    if mp > 1:
        shape[MODEL_AXIS] = mp
    return shape


class Mesh:
    """One rank's view of the mesh: the rank grid (``devices``, rank ids),
    its coordinates, and a process group per axis (``groups``; empty until
    ``init_groups``)."""

    def __init__(self, shape: Dict[str, int], rank: int = 0, sequence_parallel: bool = False):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = math.prod(shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.devices = np.arange(self.size).reshape(tuple(shape.values()))
        self.coords = {a: int(i) for a, i in
                       zip(self.axis_names, np.unravel_index(rank, self.devices.shape))}
        self.sequence_parallel = bool(sequence_parallel)
        if self.sequence_parallel:
            self.frame_axis = SEQ_AXIS if SEQ_AXIS in self.shape else DATA_AXIS
        else:
            self.frame_axis = None
        self.clip_axis = None if self.frame_axis == DATA_AXIS else DATA_AXIS
        self.groups: Dict[str, object] = {}

    def __repr__(self) -> str:
        return (f"Mesh({self.size} device(s), shape {self.shape}, rank {self.rank} at "
                f"{self.coords}, clips over {self.clip_axis}, frames over {self.frame_axis})")

    def axis_size(self, axis: Optional[str]) -> int:
        return self.shape.get(axis, 1) if axis else 1

    def axis_index(self, axis: Optional[str]) -> int:
        return self.coords.get(axis, 0) if axis else 0

    def group(self, axis: Optional[str]):
        """The process group of this rank's line along ``axis`` (None: no
        group, so collectives over it are the identity)."""
        return self.groups.get(axis) if axis else None

    def lines(self, axis: str) -> np.ndarray:
        """[n_lines, axis size] ranks of every line along ``axis``."""
        pos = self.axis_names.index(axis)
        return np.moveaxis(self.devices, pos, -1).reshape(-1, self.shape[axis])

    def init_groups(self) -> None:
        """Create the groups (every rank of the world must call this, in the
        same order, since ``new_group`` is collective)."""
        if get_world_size() != self.size:
            raise ValueError(f"a mesh of {self.size} device(s) in a world of "
                             f"{get_world_size()} rank(s)")
        if self.size == 1:
            self.groups = {DATA_AXIS: td.group.WORLD}
            return
        for axis in self.axis_names:
            if self.shape[axis] == 1:
                continue
            for line in self.lines(axis):
                g = td.new_group([int(r) for r in line])
                if self.rank in line:
                    self.groups[axis] = g

    # -- roles ------------------------------------------------------------
    @property
    def data_parallel(self) -> int:
        return self.axis_size(self.clip_axis)

    @property
    def data_index(self) -> int:
        return self.axis_index(self.clip_axis)

    @property
    def seq_parallel(self) -> int:
        return self.axis_size(self.frame_axis)

    @property
    def model_parallel(self) -> int:
        return self.axis_size(MODEL_AXIS)

    @property
    def is_group_leader(self) -> bool:
        """The first rank of its model / seq group: the one whose
        predictions count (the others compute the same)."""
        return all(i == 0 for a, i in self.coords.items() if a != self.clip_axis)


def make_mesh(num_devices: int = 0, model_parallel: int = 1, seq_parallel: int = 1,
              sequence_parallel: Optional[bool] = None,
              world_size: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """The mesh of ``num_devices`` ranks (0: the world), its groups created
    when a process group is initialised. ``sequence_parallel`` (default: a
    seq axis exists) cuts the frame axis. ``world_size`` / ``rank`` lay out
    a mesh without processes (tests)."""
    world = get_world_size() if world_size is None else world_size
    n = num_devices or world
    if n != world:
        raise ValueError(f"the mesh spans {n} device(s) but the world has {world} rank(s): "
                         "run one process per device")
    mesh = Mesh(mesh_shape(n, model_parallel, seq_parallel),
                get_rank() if rank is None else rank,
                seq_parallel > 1 if sequence_parallel is None else sequence_parallel)
    if world_size is None and td.is_available() and td.is_initialized():
        mesh.init_groups()
    return mesh


def mesh_from_config(cfg) -> Mesh:
    """The mesh of cfg.TPU: MESH_DATA is the DATA-axis size (0 = every
    rank), so with MODEL_PARALLEL=m and MESH_SEQ=s the mesh spans
    MESH_DATA*s*m ranks."""
    data = cfg.TPU.MESH_DATA
    mp = cfg.TPU.MODEL_PARALLEL
    sp = max(1, getattr(cfg.TPU, "MESH_SEQ", 1))
    return make_mesh(data * sp * mp if data else 0, model_parallel=mp, seq_parallel=sp,
                     sequence_parallel=bool(cfg.TPU.SEQUENCE_PARALLEL))


# ---------------------------------------------------------------------------
# batch layout (the JAX batch_specs / shard_batch)
# ---------------------------------------------------------------------------

def batch_specs(batch, sequence_parallel: bool, mesh: Optional[Mesh] = None) -> Dict[str, tuple]:
    """{field: partition spec} of a batch container's array fields, the
    JAX ``batch_specs`` as tuples of axis names: (data,) without sequence
    parallelism; with it frame fields (data, seq) and clip fields (data,) on
    a mesh with a seq axis, else (None, data) and ()."""
    has_seq = mesh is not None and SEQ_AXIS in mesh.axis_names
    frame = (DATA_AXIS, SEQ_AXIS) if has_seq else (None, DATA_AXIS)
    clip = (DATA_AXIS,) if has_seq else ()
    out = {}
    for f in dataclasses.fields(batch):
        if getattr(batch, f.name) is None or not hasattr(getattr(batch, f.name), "shape"):
            continue
        if not sequence_parallel:
            out[f.name] = (DATA_AXIS,)
        else:
            out[f.name] = frame if f.name in _FRAME_AXIS_FIELDS else clip
    return out


def _cut(batch, mesh: Mesh, clips: bool):
    """Each array field cut as ``batch_specs`` lays it out: along every dim
    the spec names an axis for, this rank's part of that axis (dim 0, the
    clips, only with ``clips``)."""
    specs = batch_specs(batch, mesh.sequence_parallel, mesh)
    upd = {}
    for name, spec in specs.items():
        v = getattr(batch, name)
        for dim, axis in enumerate(spec):
            n = mesh.axis_size(axis)
            if n == 1 or (dim == 0 and not clips):
                continue
            if v.shape[dim] % n:
                raise ValueError(f"{name}: {v.shape[dim]} along dim {dim} do not divide over "
                                 f"{n} '{axis}' ranks")
            w = v.shape[dim] // n
            i = mesh.axis_index(axis)
            v = v[(slice(None),) * dim + (slice(i * w, (i + 1) * w),)]
        upd[name] = v
    return dataclasses.replace(batch, **upd)


def local_batch(batch, mesh: Optional[Mesh]):
    """This rank's part of a data rank's batch (what the loader gives each
    data rank): its frames of every frame field under sequence parallelism,
    the batch itself otherwise."""
    return batch if mesh is None else _cut(batch, mesh, clips=False)


def shard_batch(batch, mesh: Optional[Mesh]):
    """This rank's part of a GLOBAL batch: its data rank's clips, then its
    frames (``local_batch``)."""
    return batch if mesh is None else _cut(batch, mesh, clips=True)


def gather_frames(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A frame-axis tensor [B, T/sp, ...] -> [B, T, ...] over the seq group
    (differentiable; the identity without sequence parallelism)."""
    if mesh is None or mesh.seq_parallel == 1:
        return x
    return collectives.gather(x, mesh.group(mesh.frame_axis), 1)


def gather_frame_fields(batch, mesh: Optional[Mesh]):
    """Every frame field of a container (targets, masks) gathered over T."""
    if mesh is None or mesh.seq_parallel == 1:
        return batch
    return dataclasses.replace(batch, **{
        f.name: gather_frames(getattr(batch, f.name), mesh) for f in dataclasses.fields(batch)
        if f.name in _FRAME_AXIS_FIELDS and isinstance(getattr(batch, f.name), torch.Tensor)})


# ---------------------------------------------------------------------------
# Tensor (model) parallelism: Megatron-style partition rules by parameter name.
#
# The JAX rules (_TP_COL / _TP_ROW on flax paths) restated on this package's
# reference names. Column-parallel (the output axis, dim 0 of a Linear
# weight, and its bias): every attention input projection -- the packed
# in_proj of a MultiHeadAttention, cut per q / k / v block by heads, and
# RoBERTa's query / key / value -- the decoder's sa_* / ca_* pre-projections,
# and the first FFN matmul (linear1, intermediate.dense). Row-parallel (the
# input axis, dim 1; bias replicated): attention out_proj
# (attention.output.dense in RoBERTa) and the second FFN matmul (linear2,
# output.dense). Everything else is replicated.
# ---------------------------------------------------------------------------

_TP_PACKED = re.compile(r"\.(?:self_attn|cross_attn_image)\.in_proj_(?:weight|bias)$")
_TP_COL = re.compile(
    r"(?:\.(?:sa|ca)_\w*_proj|\.linear1|\.attention\.self\.(?:query|key|value)"
    r"|\.intermediate\.dense)\.(?:weight|bias)$")
_TP_ROW = re.compile(r"(?:\.out_proj|\.linear2|\.output\.dense)\.weight$")


def tp_rule(name: str, ndim: int) -> Optional[Tuple[int, int]]:
    """(dim, blocks) of a sharded parameter -- cut ``dim`` into ``blocks``
    equal blocks and each block over the model axis -- or None (replicated)."""
    if _TP_PACKED.search(name):
        return (0, 3) if ndim in (1, 2) else None
    if _TP_COL.search(name):
        return (0, 1) if ndim in (1, 2) else None
    if _TP_ROW.search(name) and ndim == 2:
        return (1, 1)
    return None


def shard_tensor(t: torch.Tensor, rule: Optional[Tuple[int, int]], index: int, parts: int
                 ) -> torch.Tensor:
    """Part ``index`` of ``parts`` of a whole tensor under ``rule``."""
    if rule is None or parts == 1:
        return t
    dim, blocks = rule
    if t.shape[dim] % (blocks * parts):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide into {blocks} "
                         f"block(s) x {parts} model-parallel parts")
    return torch.cat([b.chunk(parts, dim)[index] for b in t.chunk(blocks, dim)], dim).clone()


def unshard_tensor(pieces, rule: Optional[Tuple[int, int]]) -> torch.Tensor:
    """The whole tensor from every part, in model-rank order."""
    if rule is None or len(pieces) == 1:
        return pieces[0]
    dim, blocks = rule
    split = [p.chunk(blocks, dim) for p in pieces]
    return torch.cat([torch.cat([s[b] for s in split], dim) for b in range(blocks)], dim)


def full_shape(name: str, shape: Iterable[int], parts: int) -> Tuple[int, ...]:
    """The whole parameter's shape from its part's."""
    shape = list(shape)
    rule = tp_rule(name, len(shape))
    if rule is not None:
        shape[rule[0]] *= parts
    return tuple(shape)


def sharded_names(names: Iterable[Tuple[str, int]], min_model_sharded: int = 0
                  ) -> Dict[str, Tuple[int, int]]:
    """{name: rule} of the (name, ndim) pairs the rules shard.
    ``min_model_sharded`` guards the name rules: a module rename would
    silently degrade every leaf to replication, so callers that know the
    model holds transformer weights pass > 0 and get an error instead."""
    out = {n: r for n, nd in names if (r := tp_rule(n, nd)) is not None}
    if len(out) < min_model_sharded:
        raise ValueError(
            f"tensor-parallel partition rules matched only {len(out)} leaves "
            f"(expected >= {min_model_sharded}); the _TP_COL/_TP_ROW name "
            "patterns in core/mesh.py no longer match the model's module names"
        )
    return out


def shard_state_dict(sd: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """A whole (reference-layout) state_dict -> this rank's parts."""
    if mesh is None or mesh.model_parallel == 1:
        return dict(sd)
    i, n = mesh.axis_index(MODEL_AXIS), mesh.model_parallel
    return {k: shard_tensor(v, tp_rule(k, v.dim()), i, n) for k, v in sd.items()}


def gather_state_dict(sd: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """This rank's parts -> the whole state_dict, gathered over the model
    group (collective: every rank of the group calls it)."""
    if mesh is None or mesh.model_parallel == 1:
        return dict(sd)
    group, n = mesh.group(MODEL_AXIS), mesh.model_parallel
    out = {}
    for k, v in sd.items():
        rule = tp_rule(k, v.dim())
        if rule is None:
            out[k] = v
            continue
        flat = collectives.all_gather(v.detach().reshape(1, -1), group, 0)
        out[k] = unshard_tensor([p.view_as(v) for p in flat.unbind(0)], rule)
    return out


@dataclasses.dataclass(frozen=True)
class Shard:
    """A module's place in a group: the group, this rank's index in it and
    the group's size (model parallelism: heads / hidden units split over
    ``parts``; sequence parallelism: frames)."""

    group: object
    index: int
    parts: int


def model_shard(mesh: Optional[Mesh]) -> Optional[Shard]:
    if mesh is None or mesh.model_parallel == 1:
        return None
    return Shard(mesh.group(MODEL_AXIS), mesh.axis_index(MODEL_AXIS), mesh.model_parallel)


def frame_shard(mesh: Optional[Mesh]) -> Optional[Shard]:
    if mesh is None or mesh.seq_parallel == 1:
        return None
    return Shard(mesh.group(mesh.frame_axis), mesh.axis_index(mesh.frame_axis),
                 mesh.seq_parallel)
