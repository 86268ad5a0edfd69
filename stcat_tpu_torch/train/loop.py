"""The training loop: loader -> host-to-device prefetch -> train step ->
metrics, checkpoints and validation.

    state, iteration = train(cfg, dataset_builder, max_iters=None, device=None)

In order: the mesh (``mesh_from_config``: one process, or the ranks of the
process group, logged); the train split's loader (this data rank's shard);
the model (seeded from SEED, laid out on the mesh), optimizer, EMA and step;
a checkpoint in OUTPUT_DIR resumes the run (and overrides
MODEL.WEIGHT), else MODEL.WEIGHT initialises it; SOLVER.PRE_VAL validates
first. Each iteration pulls a batch already on the card (core/prefetch.py)
and takes a step; the step's losses stay on the card, and the loop reads
them every LOG_PERIOD iterations and at the last one only, so the host does
not wait for the device in between. Those iterations append the losses, the
groups' LRs, ``step_time`` (from requesting the batch to the end of the
step), ``data_time`` (waiting for the batch) and the card's memory
(``hbm_in_use_gb``, ``hbm_peak_gb``) to OUTPUT_DIR/metrics.jsonl. Every
CHECKPOINT_PERIOD iterations the state is checkpointed in the background,
and at once (blocking) when SIGTERM has arrived, after which the loop stops;
every VAL_PERIOD iterations (but the last) the EMA weights are validated;
the final save blocks.

Spans (``core/trace.py``): each iteration is ``train.next_batch`` (the wait
on the prefetch stream) then ``train.step`` (the step, and the loss read on
a logging iteration), holding the step's ``train.grads``,
``train.optimizer`` and ``train.ema``; ``data_time`` and ``step_time`` are
read from those two spans' times. They are recorded while the recorder is
on: ``trace.enable()`` before ``train()``, ``trace.drain()`` after, or
TPU.PROFILE_STEP, which traces three steps with torch.profiler into
OUTPUT_DIR/trace/steps_<N>.json and adds those steps' spans to that trace,
on the profiler's clock (turning the recorder on for them if it was off).

Dropout draws from a ``torch.Generator`` seeded per iteration from (SEED,
iteration, data rank) (``step_generator``), so a resumed run draws what an
uninterrupted one would, and the ranks of one model or seq group, which
hold the same activations, draw the same masks (tensor-parallel parts take
their part of the whole mask, ``ops.misc.dropout``). Only the main process
writes metrics and checkpoints.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Optional

import torch

from ..core import trace
from ..core.dist import get_rank, is_main_process
from ..core.logging import MetricLogger, setup_logger
from ..core.mesh import local_batch, mesh_from_config
from ..core.metrics_writer import MetricsWriter
from ..core.prefetch import prefetch_to_device
from ..data.loader import make_loader
from ..models import build_model
from ..ops.misc import resolve_device
from .checkpoint import Checkpointer
from .convert_reference import load_pretrained_weight
from .optimizer import current_lrs, make_optimizer
from .step import create_train_state, make_train_step

LOG_PERIOD = 50


def step_generator(cfg, iteration: int, device, data_index: int = 0) -> torch.Generator:
    """The dropout generator of the step that follows ``iteration`` steps,
    on data rank ``data_index`` (0: one process's)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((cfg.SEED + 1) * 1_000_003 + iteration + (data_index << 40))
    return gen


def _default_builder(cfg, split):
    from ..data.datasets import build_dataset

    return build_dataset(cfg, split)


def train(cfg, dataset_builder=None, logger=None, max_iters: Optional[int] = None, device=None):
    """Train from OUTPUT_DIR's checkpoint, MODEL.WEIGHT or a fresh init;
    dataset_builder(cfg, split) -> dataset (default: the real benchmarks).
    Returns (TrainState, last iteration)."""
    dev = resolve_device(device)
    logger = logger or setup_logger("stcat_tpu_torch", cfg.OUTPUT_DIR, rank=get_rank())
    dataset_builder = dataset_builder or _default_builder
    mesh = mesh_from_config(cfg)
    logger.info(f"mesh: {mesh.size} device(s), shape {dict(mesh.shape)}")
    loader = make_loader(cfg, dataset_builder(cfg, "train"), "train", mesh=mesh)
    num_training_steps = cfg.SOLVER.MAX_EPOCH * loader.iters_per_epoch
    if max_iters is not None:
        num_training_steps = min(num_training_steps, max_iters)

    model = build_model(cfg, dev, seed=cfg.SEED, mesh=mesh)
    opt = make_optimizer(cfg, model, num_training_steps)
    state = create_train_state(cfg, model, opt)
    step_fn = make_train_step(cfg, model, opt, device=dev)
    lrs_at = current_lrs(cfg, num_training_steps)

    ckpt = Checkpointer(cfg.OUTPUT_DIR, logger, mesh=mesh) if cfg.OUTPUT_DIR else None
    if ckpt is not None and ckpt.has_checkpoint():
        state, loader.start_iter = ckpt.restore(state)
        logger.info(f"Resumed from iteration {loader.start_iter}")
    elif cfg.MODEL.WEIGHT:
        load_pretrained_weight(cfg, state, logger)

    eval_model = None
    if cfg.SOLVER.PRE_VAL:
        eval_model = build_model(cfg, dev, seed=cfg.SEED, mesh=mesh)
        run_validation(cfg, eval_model, state, dataset_builder, logger)

    writer = (MetricsWriter(cfg.OUTPUT_DIR, cfg.TENSORBOARD_DIR or None)
              if cfg.OUTPUT_DIR and is_main_process() else None)
    stop = threading.Event()  # SIGTERM: checkpoint at the next iteration, then stop
    prev_handler = signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    meters = MetricLogger()
    iteration = loader.start_iter
    profiler = None
    stream = prefetch_to_device(((local_batch(b, mesh), local_batch(t, mesh), m)
                                 for b, t, m in loader), dev, depth=2)
    try:
        while iteration < num_training_steps:
            with trace.Span("train.next_batch") as waited:
                try:
                    batch, targets, _meta = next(stream)
                except StopIteration:
                    break
            with trace.Span("train.step") as stepped:
                metrics = step_fn(state, batch, targets,
                                  step_generator(cfg, iteration, dev, mesh.data_index))
                iteration += 1
                log_now = iteration % LOG_PERIOD == 0 or iteration == num_training_steps
                if log_now:  # the loop's only read of the step's results: waits for the card
                    values = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
            data_time = waited.seconds
            step_time = (stepped.end - waited.start) / 1e9

            if cfg.TPU.PROFILE_STEP >= 0 and iteration == cfg.TPU.PROFILE_STEP:
                profiler, recorder_was_on = _start_profiler(dev), trace.enabled()
                profiled_from = time.perf_counter_ns()
                trace.enable()
            if profiler is not None and iteration == cfg.TPU.PROFILE_STEP + 3:
                profiler.stop()
                if not recorder_was_on:
                    trace.disable()
                path = os.path.join(cfg.OUTPUT_DIR or ".", "trace", f"steps_{iteration}.json")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                _export_trace(profiler, path, profiled_from, keep=recorder_was_on)
                profiler = None
                logger.info(f"profiler trace written to {path}")

            if log_now:
                host = {k: v for k, v in values.items() if not k.startswith("loss_") or "_0" not in k}
                meters.update(time=step_time, data=data_time, **host)
                lrs = lrs_at(iteration)
                logger.info(f"iter {iteration}/{num_training_steps}  {meters}  "
                            + "  ".join(f"lr_{k}: {v:.2e}" for k, v in lrs.items()))
                if writer is not None:
                    mem = {}
                    if dev.type == "cuda":
                        mem = {"hbm_in_use_gb": torch.cuda.memory_allocated(dev) / 2**30,
                               "hbm_peak_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
                    writer.write(iteration, {**host, **{f"lr_{k}": v for k, v in lrs.items()},
                                             "step_time": step_time, "data_time": data_time,
                                             **mem})

            if ckpt is not None and (iteration % cfg.SOLVER.CHECKPOINT_PERIOD == 0
                                     or stop.is_set()):
                ckpt.save(iteration, state, block=stop.is_set())
            if stop.is_set():
                logger.info("SIGTERM received; checkpointed and stopping")
                break

            if (cfg.SOLVER.TO_VAL and iteration % cfg.SOLVER.VAL_PERIOD == 0
                    and iteration != num_training_steps):
                if eval_model is None:
                    eval_model = build_model(cfg, dev, seed=cfg.SEED, mesh=mesh)
                run_validation(cfg, eval_model, state, dataset_builder, logger)
    finally:
        stream.close()
        if profiler is not None:
            profiler.stop()
            if not recorder_was_on:
                trace.disable()
        signal.signal(signal.SIGTERM, prev_handler)
        if writer is not None:
            writer.close()
    if ckpt is not None:
        ckpt.save(iteration, state, block=True)
    return state, iteration


def _start_profiler(dev):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=activities)
    prof.start()
    return prof


def _export_trace(profiler, path: str, since_ns: int, keep: bool) -> None:
    """The profiler's Chrome trace at ``path``, with the port's spans begun
    at or after ``since_ns`` (the profiled steps) added on the profiler's
    clock. The recorder is drained, unless ``keep``: it was on before the
    profiler, and its spans stay for whoever turned it on."""
    profiler.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    got = trace.drain(keep=keep)
    got["spans"] = [s for s in got["spans"] if s["start_ns"] >= since_ns]
    doc["traceEvents"] += trace.chrome_events(got, doc.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(doc, f)


@torch.no_grad()
def _copy_weights(eval_model, state) -> None:
    """The EMA weights (the live ones without EMA) and the model's buffers
    into ``eval_model`` in place; the training model is not touched."""
    params = dict(state.model.named_parameters())
    buffers = dict(state.model.named_buffers())
    for name, p in eval_model.named_parameters():
        p.copy_(state.ema[name] if state.ema is not None else params[name])
    for name, b in eval_model.named_buffers():
        b.copy_(buffers[name])


def run_validation(cfg, eval_model, state, dataset_builder, logger):
    """Evaluate the test split with the EMA weights on ``eval_model`` (a
    second model of the same config, built once by the caller); returns the
    evaluator's metrics, also appended with the pass's seconds and batch
    count to OUTPUT_DIR/validation.jsonl. None without a test split."""
    from ..eval.engine import do_eval
    from ..eval.evaluator import build_evaluator

    try:
        val_ds = dataset_builder(cfg, "test")
    except FileNotFoundError:
        logger.info("no test split available; skipping validation")
        return None
    loader = make_loader(cfg, val_ds, "test", mesh=eval_model.mesh)
    _copy_weights(eval_model, state)
    t0 = time.perf_counter()
    res = do_eval(cfg, eval_model, loader, build_evaluator(cfg, logger, "test"), logger)
    seconds = time.perf_counter() - t0
    logger.info(f"validation at iteration {state.step}: {loader.iters_per_epoch} batches "
                f"in {seconds:.3f} s")
    if cfg.OUTPUT_DIR and res is not None:
        writer = MetricsWriter(cfg.OUTPUT_DIR, name="validation.jsonl")
        writer.write(state.step, {**res, "seconds": seconds,
                                  "batches": loader.iters_per_epoch})
        writer.close()
    return res
