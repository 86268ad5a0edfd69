"""Host-to-device transfer pipelining.

The loader's batch pool overlaps decode and assembly with the device; this
module overlaps the host-to-device copy too. ``device_prefetch`` runs
``place`` on a background thread, ``depth`` placed items ahead of the
consumer: order is kept, an exception of the iterator or of ``place``
re-raises at the consumer's next pull, and closing the generator stops the
worker promptly.

``prefetch_to_device`` is that pipeline with the copy on the card:
  * the worker copies every array of an item into pinned host memory
    (``tensor.pin_memory()``, torch's caching host allocator, so the buffers
    are reused instead of a ``cudaHostAlloc`` per batch) and issues
    ``non_blocking`` copies on a dedicated ``torch.cuda.Stream``, records an
    event, and waits for it before it lets go of the pinned sources;
  * the consumer makes its current stream wait on that event before using
    the batch, and ``record_stream``s every tensor on it, so the caching
    allocator does not hand a batch's memory back to the copy stream while
    the step still reads it.
On the CPU the place step is a plain conversion to tensors.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Tuple, TypeVar

import numpy as np
import torch

T = TypeVar("T")
U = TypeVar("U")

_END = object()


def device_prefetch(iterator: Iterable[T], place: Callable[[T], U], depth: int = 2
                    ) -> Iterator[U]:
    """Yield place(item) for item in iterator, placing ahead of consumption."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    err: list = []
    source = iter(iterator)

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in source:
                if stop.is_set() or not _put(place(item)):
                    return
        except BaseException as e:  # re-raised at the consumer
            err.append(e)
        finally:
            if stop.is_set() and hasattr(source, "close"):
                source.close()  # the worker is the only thread that runs it
            _put(_END)

    th = threading.Thread(target=worker, daemon=True, name="device-prefetch")
    th.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def _tensor(v) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v


def _map_arrays(item, fn):
    """``fn`` over every bare array of a tuple item and every array field of
    each batch container in it (other elements, such as meta lists, pass
    through)."""
    def one(x):
        if isinstance(x, (np.ndarray, torch.Tensor)):
            return fn(_tensor(x))
        if not dataclasses.is_dataclass(x):
            return x
        upd = {f.name: fn(_tensor(getattr(x, f.name))) for f in dataclasses.fields(x)
               if isinstance(getattr(x, f.name), (np.ndarray, torch.Tensor))}
        return dataclasses.replace(x, **upd)
    return tuple(one(x) for x in item)


def _tensors(item) -> List[torch.Tensor]:
    return [x for x in item if isinstance(x, torch.Tensor)] + [
        getattr(x, f.name) for x in item if dataclasses.is_dataclass(x)
        for f in dataclasses.fields(x) if isinstance(getattr(x, f.name), torch.Tensor)]


class HostToDevice:
    """The place (worker thread) and ready (consumer thread) halves of a
    host-to-device copy of tuple items holding batch containers."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def place(self, item: tuple) -> Tuple[tuple, Optional[torch.cuda.Event]]:
        if self.stream is None:
            return _map_arrays(item, lambda t: t.to(self.device)), None
        pinned: List[torch.Tensor] = []

        def copy(t: torch.Tensor) -> torch.Tensor:
            host = t if t.is_pinned() else t.pin_memory()
            pinned.append(host)
            return host.to(self.device, non_blocking=True)

        with torch.cuda.stream(self.stream):
            out = _map_arrays(item, copy)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()  # the pinned sources outlive their copies
        del pinned
        return out, done

    def ready(self, placed: Tuple[tuple, Optional[torch.cuda.Event]]) -> tuple:
        out, done = placed
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in _tensors(out):
                t.record_stream(current)
        return out


def prefetch_to_device(iterator: Iterable[tuple], device, depth: int = 2) -> Iterator[tuple]:
    """Items of ``iterator`` with their batch containers on ``device``,
    copied ``depth`` items ahead on a background thread."""
    h2d = HostToDevice(device)
    stream = device_prefetch(iterator, h2d.place, depth)
    try:
        for placed in stream:
            yield h2d.ready(placed)
    finally:
        stream.close()
