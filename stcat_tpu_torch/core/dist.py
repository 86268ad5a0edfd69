"""Process-group helpers: start-up from the ``torchrun`` environment, rank,
world size, barrier, object gather, and ``spawn_ranks`` (N local processes
joined in one process group, for tests and card checks). Single-process
no-ops where no process group is initialised. The mesh over the ranks is
``core/mesh.py``'s.

    torchrun --nproc-per-node 4 -m stcat_tpu_torch.cli.train --dist-backend nccl ...

``init_from_env`` replaces the JAX package's ``JAX_COORDINATOR`` and
``jax.distributed.initialize``: torchrun sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT, and each rank's device is ``cuda:{LOCAL_RANK}``
unless the caller names one with an index.
"""

from __future__ import annotations

import atexit
import datetime
import os
import pickle
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as td

# a rank that dies takes the others down through this timeout on every collective
DEFAULT_TIMEOUT_S = 600


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


def all_gather_objects(obj: Any, group=None) -> List[Any]:
    """Every rank's picklable ``obj`` in rank order, over the world or over
    ``group`` (a process group this rank belongs to)."""
    n = get_world_size() if group is None else td.get_world_size(group)
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    td.all_gather_object(out, obj, group=group)
    return out


def default_backend(device) -> str:
    """nccl when the ranks run on cards, gloo on the CPU. Several ranks on
    one card need gloo, which the caller asks for by name."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device=None, local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``cuda`` (no index) becomes ``cuda:{LOCAL_RANK}``;
    a device with an index, or the CPU, stays as named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        lr = int(os.environ.get("LOCAL_RANK", 0)) if local_rank is None else local_rank
        dev = torch.device("cuda", lr)
    return dev


def init_process_group(backend: str, rank: int, world_size: int, init_method: str,
                       device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """One process group; a card rank also makes its card the current one
    (the object collectives use it), and an NCCL group is bound to it, so
    that NCCL never guesses a rank's card from its global rank (wrong on a
    second host). Destroyed when the process exits."""
    kw = {}
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
        if backend == "nccl":
            kw["device_id"] = torch.device(device)
    td.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                          timeout=datetime.timedelta(seconds=timeout_s), **kw)
    atexit.register(_shutdown)


def _shutdown() -> None:
    if _active():
        td.destroy_process_group()


def init_from_env(backend: Optional[str] = None, device=None,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group ``torchrun`` describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this rank's device.
    Without WORLD_SIZE in the environment this is one process and nothing is
    initialised. ``backend`` None: ``default_backend`` of the device."""
    dev = rank_device(device)
    if "WORLD_SIZE" not in os.environ or _active():
        return dev
    init_process_group(backend or default_backend(dev), int(os.environ["RANK"]),
                       int(os.environ["WORLD_SIZE"]), "env://", dev, timeout_s)
    return dev


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, backend, port, device, timeout_s, args, out_dir):
    """One spawned rank: join the group, run fn(rank, *args), pickle its
    result (or its traceback) into out_dir."""
    try:
        if device is not None:
            device = rank_device(device, local_rank=rank)
        init_process_group(backend, rank, world_size, f"tcp://localhost:{port}", device,
                           timeout_s)
        try:
            result = fn(rank, *args)
        finally:
            td.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(fn: Callable, world_size: int, args: Sequence = (), backend: str = "gloo",
                device=None, timeout_s: float = 300) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes (spawn) joined
    in one ``backend`` process group on localhost; return their results in
    rank order. ``fn`` must be importable by name and its result picklable.
    ``device`` as ``rank_device`` reads it: ``cuda`` puts rank r on
    ``cuda:r``, ``cuda:0`` every rank on one card (gloo only).
    The parent waits on every child: when one fails, the others are
    terminated and the tracebacks of the ranks that failed are raised here;
    a child still running after ``timeout_s`` is killed and raises too."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="stcat_ranks_") as out_dir:
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}", daemon=True,
                             args=(fn, r, world_size, backend, port, device, timeout_s,
                                   tuple(args), out_dir))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        codes: List[Optional[int]] = [None] * world_size
        try:
            while True:
                codes = [p.exitcode for p in procs]
                if all(c == 0 for c in codes) or any(c not in (None, 0) for c in codes) \
                        or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
                    p.join()
        # a rank that raised wrote its traceback before it exited, even if a
        # peer it left blocked in a collective was seen to exit first
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)
                  or os.path.exists(os.path.join(out_dir, f"{r}.err"))]
        if not failed and None in codes:
            raise RuntimeError(f"ranks {[r for r, c in enumerate(codes) if c is None]} of "
                               f"{world_size} still running after {timeout_s} s; killed")
        if failed:  # every failed rank's traceback: the first to fail may not be the cause
            why = []
            for r in failed:
                err = os.path.join(out_dir, f"{r}.err")
                why.append(f"rank {r}: " + (open(err).read() if os.path.exists(err)
                                            else f"exit code {codes[r]}"))
            raise RuntimeError(f"rank(s) {failed} of {world_size} failed:\n" + "\n".join(why))
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
