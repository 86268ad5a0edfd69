"""Checkpoints of a training run, and weights for evaluation.

``Checkpointer(OUTPUT_DIR)`` keeps ``OUTPUT_DIR/checkpoints/model_<step>.pt``
files, each one ``torch.save`` of {"step", "model" (the state_dict:
parameters and FrozenBN buffers), "optimizer"
(``GroupedOptimizer.state_dict()``: AdamW moments, the schedule's ``count``;
None in a converted checkpoint, which cannot resume training), "ema"}, and a
``last_checkpoint`` tag holding the newest committed step:

  * ``save(step, state)`` takes the device-to-host snapshot before it
    returns: every tensor is copied into pinned host memory by a
    ``non_blocking`` copy on the current stream, which orders the copies
    before the next step's in-place update. A background thread waits for
    the copies, writes the file under a temporary name and publishes it with
    ``os.replace``, so the loop does not wait for the disk;
  * the tag moves only in ``flush()``, once the file has committed, so a run
    that dies mid-write resumes from the previous complete checkpoint;
  * ``keep`` files are kept, the oldest deleted first;
  * a step is saved once: saving a step already saved or in flight is a
    no-op (the final save of a run that the period has just saved).

``load_weights_for_eval`` resolves MODEL.WEIGHT for inference: a torch file
of reference-named weights, or a checkpoint directory with the EMA weights
preferred.

On a mesh (``Checkpointer(..., mesh=)``) a checkpoint holds the whole model
in the reference layout whatever the layout that wrote it: ``save`` gathers
the tensor-parallel parts of the weights, the EMA and the optimizer's
moments over the model group (every rank calls it), and only the main
process writes; ``restore`` gives each rank its parts. So a run saved under
one layout resumes under another, bitwise.
"""

from __future__ import annotations

import copy
import os
import re
import threading
import time
from typing import Dict, Optional, Tuple

import torch

from ..core.dist import is_main_process
from ..core.mesh import full_shape, gather_state_dict, shard_state_dict

_FILE = re.compile(r"model_(\d+)\.pt$")


def _snapshot(obj):
    """A host copy of every tensor in a nested dict/list; non-tensors deep-copied."""
    if isinstance(obj, torch.Tensor):
        src = obj.detach()
        if src.device.type == "cuda":
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src, non_blocking=True)
            return host
        return src.clone()
    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v) for v in obj)
    return copy.deepcopy(obj)


def map_moments(opt_sd: Dict, names, fn) -> Dict:
    """A copy of a ``GroupedOptimizer.state_dict()`` whose per-element
    moments (exp_avg, exp_avg_sq, momentum_buffer, ...) went through
    ``fn({parameter name: tensor})``, one kind at a time."""
    state = {i: dict(st) for i, st in opt_sd["core"]["state"].items()}
    kinds = {k for st in state.values() for k, v in st.items()
             if isinstance(v, torch.Tensor) and v.dim() > 0}
    for kind in sorted(kinds):
        owners = [i for i, st in state.items() if kind in st and st[kind].dim() > 0]
        out = fn({names[i]: state[i][kind] for i in owners})
        for i in owners:
            state[i][kind] = out[names[i]]
    return {**opt_sd, "core": {**opt_sd["core"], "state": state}}


def whole_state(state, mesh) -> Dict:
    """{"model", "optimizer", "ema"} of a TrainState in the reference layout
    (gathered over the model group under tensor parallelism)."""
    opt = state.optimizer
    return {
        "model": gather_state_dict(state.model.state_dict(), mesh),
        "optimizer": None if opt is None else map_moments(
            opt.state_dict(), opt.param_names, lambda d: gather_state_dict(d, mesh)),
        "ema": None if state.ema is None else gather_state_dict(state.ema, mesh),
    }


class Checkpointer:
    def __init__(self, output_dir: str, logger=None, keep: int = 10, mesh=None):
        self.dir = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        self.logger = logger
        self.keep = keep
        self.mesh = mesh
        os.makedirs(self.dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[int] = None
        self._error: list = []
        self._saved: Optional[int] = None
        self.last_stats: Dict[str, float] = {}

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"model_{step:08d}.pt")

    def save(self, step: int, state, block: bool = False) -> None:
        """Snapshot ``state`` (a TrainState) and write it in the background;
        ``block`` waits until it has committed and the tag has moved."""
        if step in (self._saved, self._pending):
            if block:
                self.flush()
            return
        self.flush()  # the previous save commits before its tag moves
        t0 = time.perf_counter()
        whole = whole_state(state, self.mesh)
        if not is_main_process():  # the main process writes the run's checkpoint
            self._saved = step
            return
        payload = _snapshot({"step": int(step), **whole})
        done = None
        if next(state.model.parameters()).is_cuda:
            done = torch.cuda.Event()
            done.record()
        snapshot_s = time.perf_counter() - t0
        self._pending = step
        self._thread = threading.Thread(target=self._write, name="checkpoint-writer",
                                        args=(step, payload, done, t0, snapshot_s), daemon=True)
        self._thread.start()
        if self.logger:
            self.logger.info(f"Checkpoint {step}: device snapshot taken in {snapshot_s:.3f} s, "
                             "committing in the background")
        if block:
            self.flush()

    def _write(self, step, payload, done, t0, snapshot_s) -> None:
        try:
            if done is not None:
                done.synchronize()
            final = self.path(step)
            tmp = f"{final}.tmp-{os.getpid()}"
            torch.save(payload, tmp)
            os.replace(tmp, final)
            self.last_stats = {"step": step, "bytes": os.path.getsize(final),
                               "snapshot_s": snapshot_s,
                               "commit_s": time.perf_counter() - t0}
        except BaseException as e:  # re-raised by flush() on the caller's thread
            self._error.append(e)

    def flush(self) -> None:
        """Wait for the save in flight, if any, to commit; then publish its
        tag and drop checkpoints beyond ``keep``."""
        if self._pending is None:
            return
        self._thread.join()
        step, self._pending, self._thread = self._pending, None, None
        if self._error:
            raise self._error.pop()
        tag = os.path.join(self.dir, "last_checkpoint")
        with open(tag + ".tmp", "w") as f:
            f.write(str(step))
        os.replace(tag + ".tmp", tag)
        self._saved = step
        steps = sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(self.dir)) if m)
        for old in steps[:-self.keep]:
            os.remove(self.path(old))
        if self.logger:
            s = self.last_stats
            self.logger.info(f"Saved checkpoint at iteration {step} ({s['bytes']} bytes, "
                             f"committed {s['commit_s']:.3f} s after the save began)")

    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.dir, "last_checkpoint"))

    def last_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "last_checkpoint")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def _load(self, step: Optional[int]) -> Dict:
        step = self.last_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore(self, state, step: Optional[int] = None) -> Tuple[object, int]:
        """Load a checkpoint into a TrainState in place (resume); returns
        (state, step)."""
        payload = self._load(step)
        if payload["optimizer"] is None:
            raise ValueError(
                f"{self.dir} holds weights without optimizer state (a converted checkpoint, "
                "cli/convert.py), so training cannot resume from it; pass it as MODEL.WEIGHT "
                "to evaluate or serve it")
        mesh, opt = self.mesh, state.optimizer
        state.model.load_state_dict(shard_state_dict(payload["model"], mesh), strict=True)
        opt.load_state_dict(map_moments(payload["optimizer"], opt.param_names,
                                        lambda d: shard_state_dict(d, mesh)))
        if (state.ema is None) != (payload["ema"] is None):
            raise ValueError("the checkpoint and the run disagree on MODEL.EMA")
        if state.ema is not None:
            if set(state.ema) != set(payload["ema"]):
                raise ValueError("the checkpoint's EMA holds other parameters than the model")
            with torch.no_grad():
                for name, value in shard_state_dict(payload["ema"], mesh).items():
                    state.ema[name].copy_(value)
        state.step = int(payload["step"])
        return state, state.step

    def restore_for_eval(self, template: Dict[str, torch.Tensor], step: Optional[int] = None
                         ) -> Dict[str, torch.Tensor]:
        """The state_dict to evaluate, EMA weights preferred (buffers from
        the model), checked against ``template`` (a fresh model's
        state_dict, this rank's parts on a mesh): the same keys and whole
        shapes, cast to its dtypes, cut to this rank's parts."""
        payload = self._load(step)
        chosen = dict(payload["model"])
        if payload.get("ema") is not None:
            chosen.update(payload["ema"])
        missing, extra = set(template) - set(chosen), set(chosen) - set(template)
        if missing or extra:
            raise ValueError(f"checkpoint in {self.dir}: keys differ from the model's "
                             f"(missing {sorted(missing)[:4]}, extra {sorted(extra)[:4]})")
        parts = 1 if self.mesh is None else self.mesh.model_parallel
        out = {}
        for name, want in template.items():
            got, shape = chosen[name], full_shape(name, want.shape, parts)
            if tuple(got.shape) != shape:
                raise ValueError(f"checkpoint {name}: shape {tuple(got.shape)} != expected "
                                 f"{shape}")
            out[name] = got.to(want.dtype)
        return shard_state_dict(out, self.mesh)


def load_torch_file(path: str) -> Dict:
    """A torch checkpoint's state_dict (the "model" entry when it has one)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return ckpt


def load_weights_for_eval(model: torch.nn.Module, weight: str, logger=None) -> None:
    """MODEL.WEIGHT into ``model``, in place: '' keeps its weights; a
    *.pth/*.pt/*.bin file is a reference-named state_dict; a directory is a
    run's OUTPUT_DIR (or its checkpoints/), EMA weights preferred."""
    if not weight:
        return
    if weight.endswith((".pth", ".pt", ".bin")):
        from .convert_reference import load_reference_state_dict

        load_reference_state_dict(model, load_torch_file(weight), logger=logger)
        if logger is not None:
            logger.info(f"loaded torch weights from {weight}")
        return
    base = weight.rstrip("/")
    if base.endswith("checkpoints"):
        base = os.path.dirname(base)
    sd = Checkpointer(base, logger, mesh=getattr(model, "mesh", None)).restore_for_eval(
        model.state_dict())
    model.load_state_dict(sd, strict=True)
    if logger is not None:
        logger.info(f"loaded weights from {weight} (EMA preferred)")
