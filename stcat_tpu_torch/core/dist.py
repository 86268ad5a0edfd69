"""Process-group helpers: rank, world size, barrier and object gather through
``torch.distributed`` when a process group is initialised, single-process
no-ops otherwise. Multi-GPU training itself is ROADMAP Queue A item 7."""

from __future__ import annotations

from typing import Any, List

import torch.distributed as td


def _active() -> bool:
    return td.is_available() and td.is_initialized()


def get_world_size() -> int:
    return td.get_world_size() if _active() else 1


def get_rank() -> int:
    return td.get_rank() if _active() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    if get_world_size() > 1:
        td.barrier()


def all_gather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * get_world_size()
    td.all_gather_object(out, obj)
    return out
