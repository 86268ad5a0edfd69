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
"""

from __future__ import annotations

import copy
import os
import re
import threading
import time
from typing import Dict, Optional, Tuple

import torch

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


class Checkpointer:
    def __init__(self, output_dir: str, logger=None, keep: int = 10):
        self.dir = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        self.logger = logger
        self.keep = keep
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
        payload = _snapshot({
            "step": int(step),
            "model": state.model.state_dict(),
            "optimizer": None if state.optimizer is None else state.optimizer.state_dict(),
            "ema": state.ema,
        })
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
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        if (state.ema is None) != (payload["ema"] is None):
            raise ValueError("the checkpoint and the run disagree on MODEL.EMA")
        if state.ema is not None:
            if set(state.ema) != set(payload["ema"]):
                raise ValueError("the checkpoint's EMA holds other parameters than the model")
            with torch.no_grad():
                for name, value in payload["ema"].items():
                    state.ema[name].copy_(value)
        state.step = int(payload["step"])
        return state, state.step

    def restore_for_eval(self, template: Dict[str, torch.Tensor], step: Optional[int] = None
                         ) -> Dict[str, torch.Tensor]:
        """The state_dict to evaluate, EMA weights preferred (buffers from
        the model), checked against ``template`` (a fresh model's
        state_dict): the same keys and shapes, cast to its dtypes."""
        payload = self._load(step)
        chosen = dict(payload["model"])
        if payload.get("ema") is not None:
            chosen.update(payload["ema"])
        missing, extra = set(template) - set(chosen), set(chosen) - set(template)
        if missing or extra:
            raise ValueError(f"checkpoint in {self.dir}: keys differ from the model's "
                             f"(missing {sorted(missing)[:4]}, extra {sorted(extra)[:4]})")
        out = {}
        for name, want in template.items():
            got = chosen[name]
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(f"checkpoint {name}: shape {tuple(got.shape)} != expected "
                                 f"{tuple(want.shape)}")
            out[name] = got.to(want.dtype)
        return out


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
    sd = Checkpointer(base, logger).restore_for_eval(model.state_dict())
    model.load_state_dict(sd, strict=True)
    if logger is not None:
        logger.info(f"loaded weights from {weight} (EMA preferred)")
