"""The training cell: what ``cli.train`` runs, in a closed loop.

Set-up builds what ``train/loop.py::train`` builds (mesh, loader over the
synthetic corpus, model, optimizer, EMA, step), runs one step of every
batch shape the window can meet on a throwaway optimizer (cuDNN picks its
algorithms per shape in each process; the shapes are listed as
``cli/precompile.py`` lists them, without decoding a pixel), and then loads
the benchmark's weights under a fresh optimizer and EMA. The first three
iterations go through the window's own feed (``prefetch_to_device`` over
the loader) and step, and the run keeps what
the comparison needs: each step's loss, each trainable leaf's first moment
after step 1 (the clipped gradient x 0.1) and its change after step 3, and
the three batches. The window then steps the same state on, back to back,
from iteration 3, and ends with a synchronize.

After the window the port's state is freed and the reference trains a
fresh copy of the same weights three steps on the same clips: its own JPEG
decode, tokenizer, resample and loss; the items, frames and targets
worked out from the corpus annotations (``reference/sampling.py``) and
compared with the loader's; the batch's spatial augmentation plan taken
from the loader (the reference does not redraw it); and the port's dropout
masks replayed from the same generator seeds.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from .. import generate, harness, roofline, stats, weights
from ..reference import infer as rinfer
from ..reference import sampling
from ..reference.model import FP32, STCAT, arch_of
from ..reference.train import Trainer, total_loss

CHECK_STEPS = 3
BETA1 = 0.9


def _norms(named) -> Dict[str, float]:
    return {n: float(t.detach().double().norm()) for n, t in named}


def dropout_generator(cfg_seed: int, iteration: int, device, data_index: int = 0):
    """The seed rule of the masks of the step after ``iteration`` steps."""
    gen = torch.Generator(device=device)
    gen.manual_seed((cfg_seed + 1) * 1_000_003 + iteration + (data_index << 40))
    return gen


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> Dict[str, float]:
    """Each leaf's |program norm - reference norm|, over the larger of its
    reference norm and the median leaf's."""
    med = float(np.median([ref[n] for n in keep]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in keep}


def compare(losses, first: Dict[str, float], change: Dict[str, torch.Tensor], ref: Dict):
    """The numbers a training cell's run is held to, and the worst leaves.

    Leaves whose reference gradient norm is under a thousandth of the median
    leaf's are left out, and, inside a leaf, the change of every element
    whose reference gradient is under a thousandth of its leaf's rms: such a
    gradient is nought to rounding (the key third of a packed attention
    bias, under softmax) and Adam moves its element by round-off alone."""
    moment = ref["moment"]
    med = float(np.median(list(ref["first"].values())))
    keep = [n for n in ref["first"] if ref["first"][n] >= 1e-3 * med]
    prog_c, ref_c, masked = {}, {}, 0
    for n in keep:
        live = moment[n].abs() >= 1e-3 * ref["first"][n] / moment[n].numel() ** 0.5
        masked += int(live.numel() - live.sum())
        prog_c[n] = float(change[n].to(live.device).double()[live].norm())
        ref_c[n] = float(ref["change"][n].double()[live].norm())
    g = leaf_gaps(first, ref["first"], keep)
    c = leaf_gaps(prog_c, ref_c, keep)
    rel = [abs(p - r) / abs(r) for p, r in zip(losses, ref["losses"])]
    numbers = {"loss_rel": max(rel), "loss_first_rel": rel[0], "grad_leaf": max(g.values()),
               "change_leaf": max(c.values()), "grad_median": float(np.median(list(g.values()))),
               "change_median": float(np.median(list(c.values()))),
               "left_out": float(len(ref["first"]) - len(keep)), "masked": float(masked),
               "sample_off": ref["sample_off"], "box_target": ref["box_target"]}
    worst = {"grad": max(g, key=g.get), "change": max(c, key=c.get)}
    return numbers, worst


def run(spec) -> harness.Outcome:
    from stcat_tpu_torch.core.mesh import local_batch, mesh_from_config
    from stcat_tpu_torch.core.prefetch import prefetch_to_device
    from stcat_tpu_torch.data.datasets import build_dataset
    from stcat_tpu_torch.data.loader import make_loader
    from stcat_tpu_torch.models import build_model
    from stcat_tpu_torch.train.loop import step_generator
    from stcat_tpu_torch.train.optimizer import make_optimizer
    from stcat_tpu_torch.train.step import create_train_state, make_train_step

    dev, traffic, spans = spec.device, spec.traffic, spec.spans
    data_dir = spec.work.name
    phases = {"start": time.perf_counter() - spec.t_start}
    corpus = generate.write_corpus(traffic, spec.seed, data_dir)
    phases["corpus"] = time.perf_counter() - spec.t_start
    cfg = harness.port_config(spec.conf, "DATA_DIR", data_dir)
    arch = arch_of(spec.conf["config"])
    mesh = mesh_from_config(cfg)
    loader = make_loader(cfg, build_dataset(cfg, "train"), "train", mesh=mesh)
    total_steps = cfg.SOLVER.MAX_EPOCH * loader.iters_per_epoch
    model = build_model(cfg, dev, seed=cfg.SEED, mesh=mesh)
    phases["build_model"] = time.perf_counter() - spec.t_start
    reach = CHECK_STEPS + math.ceil(spec.seconds * traffic["warm_steps_per_s"])
    warmed = warm_shapes(cfg, loader, model, dev, mesh, reach, total_steps)
    spec.sync()
    phases["warm_shapes"] = time.perf_counter() - spec.t_start
    model.load_state_dict(weights.draw(arch, spec.seed, dev))
    phases["weights"] = time.perf_counter() - spec.t_start
    opt = make_optimizer(cfg, model, total_steps)
    state = create_train_state(cfg, model, opt)
    step = make_train_step(cfg, model, opt, device=dev)
    trainable = list(zip(opt.param_names, opt.trainable))
    start = {n: p.detach().clone() for n, p in trainable}
    stream = prefetch_to_device(((local_batch(b, mesh), local_batch(t, mesh), m)
                                 for b, t, m in loader), dev, depth=2)
    kept, losses = [], []
    for it in range(CHECK_STEPS):
        batch, targets, meta = next(stream)
        kept.append((_to_cpu(batch), _to_cpu(targets), meta))  # off the card, as below
        losses.append(step(state, batch, targets,
                           step_generator(cfg, it, dev, mesh.data_index))["loss"])
        if it == 0:
            # a leaf the optimizer kept no moment for reads 0
            first = _norms((n, opt.core.state.get(p, {}).get("exp_avg", torch.zeros(())))
                           for n, p in trainable)
    # off the card, so that the window's memory peak is the port's alone
    change = {n: (p.detach() - start[n]).cpu() for n, p in trainable}
    del start
    prog_losses = [float(x) for x in losses]
    spec.sync()
    phases["check_steps"] = time.perf_counter() - spec.t_start

    # the window
    if spec.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    it, shapes = CHECK_STEPS, []
    t0 = time.perf_counter()
    spec.setup_done(t0)
    marks = spec.start_trace(t0)
    while True:
        with spans.span("next_batch"):
            batch, targets, meta = next(stream)
        with spans.span("step"):
            step(state, batch, targets, step_generator(cfg, it, dev, mesh.data_index))
        shapes.append(tuple(batch.frame_valid.shape[:2]) + tuple(batch.out_canvas))
        it += 1
        marks.tick(len(shapes))
        if time.perf_counter() - t0 >= spec.seconds:
            break
    spec.sync()
    t1 = time.perf_counter()
    marks.close(len(shapes), t1)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stream.close()
    clips = sum(s[0] for s in shapes)  # this data rank's
    window_s = t1 - t0
    del state, step, opt, model, batch, targets
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    solver = spec.conf["config"]["SOLVER"]

    def flops_of(shape):
        return roofline.count_flops(arch, shape[0], shape[1], shape[2:], cfg.INPUT.MAX_QUERY_LEN,
                                    True, solver)

    readings = spec.readings(kind="train", window=(t0, t1), clips=clips, shapes=shapes,
                             marks=marks, flops_of=flops_of)

    # the reference: on rank 0, over every data rank's clips
    shards = _gather_shards(kept, mesh.data_index)
    if shards is None:
        return harness.Outcome(end_to_end={"train_clips_per_s": stats.rate(
                                   clips * mesh.data_parallel, window_s)},
                               attempted=clips, failed=0, checks=[],
                               memory_peak_bytes=peak, readings=readings)
    with harness.exact_fp32():
        ref = _reference_follow(spec, cfg, arch, corpus, shards, total_steps, data_dir)
    numbers, worst = compare(prog_losses, first, change, ref)
    checks = [harness.Check(k, numbers[k], v) for k, v in spec.limits.items()]
    return harness.Outcome(
        end_to_end={"train_clips_per_s": stats.rate(clips * mesh.data_parallel, window_s)},
        attempted=clips, failed=0, checks=checks, memory_peak_bytes=peak,
        readings=readings,
        notes={"losses": prog_losses, "ref_losses": ref["losses"], "numbers": numbers,
               "worst": worst, "steps": len(shapes), "window_s": window_s,
               "warmed_shapes": len(warmed),
               "unwarmed_steps": sum(s not in warmed for s in shapes),
               "halves": _halves(spans, t0, t1), "setup_phases_s": phases})


def _halves(spans, t0: float, t1: float):
    """Steps begun in the window's first and second half, and the median
    host seconds of a step in each."""
    mid = (t0 + t1) / 2
    steps = [(a, b - a) for n, a, b in spans.records if n == "step"]
    med = lambda xs: float(np.median(xs)) if xs else None  # noqa: E731
    return {"first": sum(a < mid for a, _ in steps), "second": sum(a >= mid for a, _ in steps),
            "first_median_s": med([d for a, d in steps if a < mid]),
            "second_median_s": med([d for a, d in steps if a >= mid])}


def warm_shapes(cfg, loader, model, dev, mesh, reach: int, total_steps: int):
    """One training step of each batch shape the loader emits in its first
    ``reach`` iterations (whole epochs: ``Loader.scan_signatures``, zero
    pixels), through a throwaway optimizer and train state; the model's
    weights and gradients are for the caller to replace. Returns the
    window's shape keys, (B, T, canvas h, canvas w), of those shapes."""
    from stcat_tpu_torch.core.mesh import local_batch
    from stcat_tpu_torch.train.loop import step_generator
    from stcat_tpu_torch.train.optimizer import make_optimizer
    from stcat_tpu_torch.train.step import create_train_state, make_train_step

    sigs = loader.scan_signatures(math.ceil(reach / loader.iters_per_epoch))
    opt = make_optimizer(cfg, model, total_steps)
    state = create_train_state(cfg, model, opt)
    step = make_train_step(cfg, model, opt, device=dev)
    for samples in sigs.values():
        batch, targets, _ = loader._make_batch(samples)
        step(state, local_batch(batch, mesh), local_batch(targets, mesh),
             step_generator(cfg, 0, dev, mesh.data_index))
    model.zero_grad(set_to_none=True)
    return {(b, t) + tuple(out) for b, t, _, out, _ in sigs}


def _gather_shards(kept, data_index: int):
    """Per step, every data rank's (batch, targets, meta, data index) from
    the host copies in ``kept``, on rank 0 (None elsewhere); one process:
    its own."""
    from stcat_tpu_torch.core.dist import all_gather_objects, get_rank, get_world_size

    mine = [(b, t, m, data_index) for b, t, m in kept]
    if get_world_size() == 1:
        return [[s] for s in mine]
    every = all_gather_objects(mine)
    if get_rank() != 0:
        return None
    seen, steps = set(), []
    for it in range(len(kept)):
        row = []
        for rank_kept in every:  # one shard per data rank
            if rank_kept[it][3] not in seen:
                seen.add(rank_kept[it][3])
                row.append(rank_kept[it])
        seen.clear()
        steps.append(row)
    return steps


def _to_cpu(container):
    import dataclasses

    return dataclasses.replace(container, **{
        f.name: getattr(container, f.name).cpu() for f in dataclasses.fields(container)
        if isinstance(getattr(container, f.name), torch.Tensor)})


def _reference_follow(spec, cfg, arch, corpus, shards, total_steps, data_dir) -> Dict:
    """The reference's three steps on the kept clips from the same weights:
    each data rank's clips with that rank's masks, the loss their mean.
    Which item each slot loads, its frames and its targets the reference
    works out from the corpus (``reference/sampling.py``); ``sample_off``
    and ``box_target`` say how far the port's loader strayed from them."""
    dev = spec.device
    items = corpus["items"]
    solver = spec.conf["config"]["SOLVER"]
    model = _reference_model(arch, spec, dev, spec.reference_ops)
    model.vis_encoder[0].body.remat = True
    trainer = Trainer(model, solver, total_steps)
    start = {n: p.detach().clone() for n, p in trainer.named}
    losses, sample_off, box_target = [], 0, 0.0
    for it, row in enumerate(shards):
        made = []
        for batch, targets, meta, index in row:
            tg, picked, off, gap = _reference_targets(cfg, items, it, batch, targets, meta,
                                                      index, len(row))
            sample_off, box_target = sample_off + off, max(box_target, gap)
            made.append((_to_device(batch, dev), {k: v.to(dev) for k, v in tg.items()}, picked,
                         index))
        boxes = sum(tg["box_valid"].sum().float() for _, tg, _, _ in made)
        clips = sum(tg["box_valid"].shape[0] for _, tg, _, _ in made)
        num_boxes = (boxes / clips).clamp(min=1.0)
        model.train()
        step_loss = 0.0
        for batch, tg, picked, index in made:
            frames, fv, pv, ids, tv = _reference_inputs(cfg, batch, picked, data_dir)
            with torch.enable_grad():
                out = model(frames, fv, pv, ids, tv, dropout_generator(cfg.SEED, it, dev, index))
                loss = total_loss(out, tg, fv, solver, arch["DEC_LAYERS"], num_boxes) / len(made)
                loss.backward()
            step_loss += float(loss.detach())
        losses.append(step_loss)
        trainer.step()
        model.zero_grad(set_to_none=True)
        if it == 0:
            moment = {n: m.clone() for n, m in trainer.first_moments().items()}
    change = {n: p.detach() - start[n] for n, p in trainer.named}
    return {"losses": losses, "first": _norms(moment.items()), "moment": moment,
            "change": change, "sample_off": float(sample_off), "box_target": box_target}


def _reference_targets(cfg, items, it, batch, targets, meta, rank, ranks):
    """(targets as torch tensors, (item, frame ids) per clip, mismatches,
    widest box gap) of one data rank's batch at iteration ``it``: the
    items, frames and targets worked out from the corpus against those of
    the port's loader.
    A mismatch is an item, a frame id, an actioness or box-valid flag or a
    span end that differs; the box gap is the largest |port - reference|
    normalised box coordinate on frames both mark valid."""
    per_rank = batch.frame_valid.shape[0]
    want = sampling.item_indices(cfg.SEED, it, len(items), per_rank, ranks, rank,
                                 bool(cfg.SOLVER.SHUFFLE))
    inp = {k: getattr(cfg.INPUT, k) for k in ("TRAIN_SAMPLE_NUM", "TEMP_CROP_PROB", "SAMPLE_FPS")}
    made = []
    for b, m in enumerate(meta):
        item = items[want[b]]
        keep = sampling.keep_of(item, cfg.DATASET.NAME, "train", inp,
                                sampling.sample_rng(cfg.SEED, it, want[b]))
        made.append((item, keep))
    t = min(x for x in cfg.TPU.FRAME_BUCKETS if x >= max(len(k) for _, k in made))
    tg = [sampling.targets(item, keep, t, bool(batch.flip[b]), batch.affine_scale[b].tolist(),
                           batch.affine_off[b].tolist(), batch.frames_u8.shape[3],
                           batch.out_size[b].tolist()) for b, (item, keep) in enumerate(made)]
    off, gap = 0, 0.0
    for b, (m, r) in enumerate(zip(meta, tg)):
        off += int(m["item_id"] != want[b])
        fids = list(m["frame_ids"])
        off += sum(x != y for x, y in zip(fids, r["frame_ids"]))
        off += abs(len(fids) - len(r["frame_ids"]))
        n = min(t, targets.actioness.shape[1])
        port_act = targets.actioness[b].numpy()
        port_valid = targets.box_valid[b].numpy().astype(bool)
        off += int((port_act[:n] != r["actioness"][:n]).sum())
        off += abs(t - targets.actioness.shape[1])
        off += int((port_valid[:n] != r["box_valid"][:n]).sum())
        off += int((targets.temp_bound[b].numpy() != r["temp_bound"]).sum())
        both = port_valid[:n] & r["box_valid"][:n]
        if both.any():
            port_box = targets.boxes[b].numpy()[:n][both].astype(np.float64)
            gap = max(gap, float(np.abs(port_box - r["boxes"][:n][both]).max()))
    as_t = {"boxes": torch.from_numpy(np.stack([r["boxes"] for r in tg])).float(),
            "box_valid": torch.from_numpy(np.stack([r["box_valid"] for r in tg])),
            "actioness": torch.from_numpy(np.stack([r["actioness"] for r in tg])),
            "temp_bound": torch.from_numpy(np.stack([r["temp_bound"] for r in tg]))}
    return as_t, [(item, r["frame_ids"]) for (item, _), r in zip(made, tg)], off, gap


def _to_device(container, dev):
    import dataclasses

    return dataclasses.replace(container, **{
        f.name: getattr(container, f.name).to(dev) for f in dataclasses.fields(container)
        if isinstance(getattr(container, f.name), torch.Tensor)})


def _reference_model(arch, spec, dev, ops):
    with torch.device("meta"):
        model = STCAT(arch, ops)
    model = model.to_empty(device=dev)
    model.load_state_dict(weights.draw(arch, spec.seed, dev))
    return model


def _reference_inputs(cfg, batch, picked, data_dir):
    """The model inputs of a training batch, made by the reference: each
    picked (item, frame ids) decoded from the corpus and resampled along
    the batch's plan, the sentence tokenized (left and right exchanged
    where the plan flips)."""
    dev = batch.frame_valid.device
    clips, texts = [], []
    fids = [f for _, f in picked]
    for b, (item, f) in enumerate(picked):
        clips.append(rinfer.decode(data_dir, item["vid"], f))
        text = item["description"].lower()
        texts.append(rinfer.swap_left_right(text) if bool(batch.flip[b]) else text)
    t = min(x for x in cfg.TPU.FRAME_BUCKETS if x >= max(len(f) for f in fids))
    fv = torch.zeros(len(fids), t, dtype=torch.bool, device=dev)
    for b, f in enumerate(fids):
        fv[b, :len(f)] = True
    hs, ws = batch.frames_u8.shape[2:4]
    raw = torch.from_numpy(rinfer.canvas(clips, t, hs, ws)).to(dev)
    frames, pv = rinfer.preprocess_raw(raw, batch.flip, batch.affine_scale, batch.affine_off,
                                       batch.out_canvas, batch.out_size, fv,
                                       list(cfg.INPUT.PIXEL_MEAN), list(cfg.INPUT.PIXEL_STD))
    ids, tv = rinfer.tokenize(texts, cfg.INPUT.MAX_QUERY_LEN, cfg.MODEL.TEXT_MODEL.VOCAB_SIZE)
    return frames, fv, pv, torch.from_numpy(ids).to(dev), torch.from_numpy(tv).to(dev)


def control(spec) -> Dict[str, float]:
    """The compared numbers with the reference in ``spec.reference_ops``
    (float8 operands) in the port's place, on the cell's first three
    batches from the port's loader, against the float32 reference."""
    from stcat_tpu_torch.core.prefetch import prefetch_to_device
    from stcat_tpu_torch.data.datasets import build_dataset
    from stcat_tpu_torch.data.loader import make_loader

    from ..reference.model import FP32

    data_dir = spec.work.name
    corpus = generate.write_corpus(spec.traffic, spec.seed, data_dir)
    cfg = harness.port_config(spec.conf, "DATA_DIR", data_dir)
    arch = arch_of(spec.conf["config"])
    loader = make_loader(cfg, build_dataset(cfg, "train"), "train")
    total_steps = cfg.SOLVER.MAX_EPOCH * loader.iters_per_epoch
    stream = prefetch_to_device(iter(loader), spec.device, depth=2)
    shards = [[(*next(stream), 0)] for _ in range(CHECK_STEPS)]
    stream.close()
    with harness.exact_fp32():
        low = _reference_follow(spec, cfg, arch, corpus, shards, total_steps, data_dir)
        ops, spec.reference_ops = spec.reference_ops, FP32
        ref = _reference_follow(spec, cfg, arch, corpus, shards, total_steps, data_dir)
        spec.reference_ops = ops
        numbers, worst = compare(low["losses"], low["first"], low["change"], ref)
    return {**numbers, "worst": worst}
