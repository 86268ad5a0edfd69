"""The evaluation cell: ``eval.engine.do_eval`` over the synthetic test
split, as ``cli.test`` runs it (the model's mesh, the test loader with its
decode threads, the evaluator).

Set-up loads the benchmark's weights and evaluates the split's first
batches once (this builds the attention kernel in a fresh checkout). The
window evaluates the split from its start through a feed that ends at the
deadline; the pass then drains and the evaluator summarises. With
``--trace 1`` the window's first TRACE seconds are one pass under the
profiler and the rest a second pass. Afterwards the reference answers a
sample of the clips from the corpus, and recomputes the evaluator's
metrics from the predictions the evaluator received.
"""

from __future__ import annotations

import gc
import itertools
import time

import numpy as np
import torch

from .. import generate, harness, roofline, stats, weights
from ..reference import evaluate as revaluate
from ..reference import infer as rinfer
from ..reference.model import STCAT, arch_of
from .answers import gaps, reference_answer


def test_frame_ids(item, n_target: int):
    """The test clip's frame ids: the whole segment, spread evenly over
    ``n_target`` frames when longer."""
    fids = list(item["frame_ids"])
    if len(fids) > n_target:
        fids = [fids[int(i)] for i in np.linspace(0, len(fids) - 1, num=n_target)]
    return fids


def run(spec) -> harness.Outcome:
    from stcat_tpu_torch.core.mesh import mesh_from_config
    from stcat_tpu_torch.data.datasets import build_dataset
    from stcat_tpu_torch.data.loader import make_loader
    from stcat_tpu_torch.eval.engine import do_eval
    from stcat_tpu_torch.eval.evaluator import build_evaluator
    from stcat_tpu_torch.models import build_model

    dev, traffic, spans = spec.device, spec.traffic, spec.spans
    data_dir = spec.work.name
    corpus = generate.write_corpus(traffic, spec.seed, data_dir)
    cfg = harness.port_config(spec.conf, "DATA_DIR", data_dir)
    arch = arch_of(spec.conf["config"])
    mesh = mesh_from_config(cfg)
    model = build_model(cfg, dev, seed=cfg.SEED, mesh=mesh)
    model.load_state_dict(weights.draw(arch, spec.seed, dev))
    dataset = build_dataset(cfg, "test")
    shapes = []

    def feed(deadline):
        loader = make_loader(cfg, dataset, "test", mesh=mesh)
        for item in loader:
            if time.perf_counter() >= deadline:
                return
            shapes.append(tuple(item[0].frame_valid.shape[:2]) + tuple(item[0].out_canvas))
            yield item

    do_eval(cfg, model, itertools.islice(make_loader(cfg, dataset, "test", mesh=mesh),
                                         traffic["warm_batches"]),
            build_evaluator(cfg, None, "test"))
    spec.sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    spec.setup_done(t0)
    marks = spec.start_trace(t0)
    if spec.trace:
        with spans.span("do_eval"):
            do_eval(cfg, model, feed(t0 + marks.seconds), build_evaluator(cfg, None, "test"))
        marks.close(len(shapes), time.perf_counter())
    evaluator = build_evaluator(cfg, None, "test")
    with spans.span("do_eval"):
        summary = do_eval(cfg, model, feed(t0 + spec.seconds), evaluator)
    spec.sync()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    clips = sum(s[0] for s in shapes)
    predictions, video_predictions = evaluator.predictions, evaluator.video_predictions
    del model, evaluator
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    items = {it["item_id"]: it for it in corpus["items"]}
    annos = {it["item_id"]: {"gt_temp_bound": it["gt_temp_bound"],
                             "bboxs": {str(f): b for f, b in zip(
                                 it["frame_ids"][it["actioness"].index(1.0):], it["bboxs"])}}
             for it in corpus["items"]}
    ref_summary = revaluate.summarize(annos, predictions, video_predictions,
                                      per_qtype=traffic["dataset"] == "VidSTG")
    metric_gap = max(abs(ref_summary[k] - summary[k]) for k in ref_summary) if (
        summary is not None and set(ref_summary) == set(summary)) else float("inf")
    rng = np.random.default_rng([spec.seed % (2 ** 63), 17])
    done = sorted(video_predictions)
    sample = sorted(rng.choice(done, size=min(traffic["check_clips"], len(done)),
                               replace=False).tolist())
    with harness.exact_fp32():
        box, span = check(spec, arch, cfg, data_dir, items, sample, predictions,
                          video_predictions)
    checks = [harness.Check("box_px", box, spec.limits["box_px"]),
              harness.Check("span_gap", span, spec.limits["span_gap"]),
              harness.Check("metrics_abs", metric_gap, spec.limits["metrics_abs"])]
    t_in = 2 * cfg.INPUT.TRAIN_SAMPLE_NUM

    def flops_of(shape):
        return roofline.count_flops(arch, 2 * shape[0], (t_in + 1) // 2, shape[2:],
                                    cfg.INPUT.MAX_QUERY_LEN, False)

    readings = spec.readings(kind="eval", window=(t0, t1), clips=clips, shapes=shapes,
                             marks=marks, flops_of=flops_of, arch=arch,
                             max_query_len=cfg.INPUT.MAX_QUERY_LEN)
    return harness.Outcome(end_to_end={"eval_clips_per_s": stats.rate(clips, t1 - t0)}, attempted=clips,
                           failed=0, checks=checks, memory_peak_bytes=peak, readings=readings,
                           notes={"clips": clips, "window_s": t1 - t0, "summary": summary})


def check(spec, arch, cfg, data_dir, items, sample, predictions, video_predictions):
    """(worst box_px, worst span_gap) of the sampled clips' answers, as the
    evaluator received them, against the reference's."""
    with torch.device("meta"):
        model = STCAT(arch, spec.reference_ops)
    model = model.to_empty(device=spec.device)
    model.load_state_dict(weights.draw(arch, spec.seed, spec.device))
    t_in = 2 * cfg.INPUT.TRAIN_SAMPLE_NUM
    bucket = min(b for b in cfg.TPU.FRAME_BUCKETS if b >= (t_in + 1) // 2)
    box = span = 0.0
    for vid in sample:
        item = items[vid]
        fids = test_frame_ids(item, t_in)
        frames = rinfer.decode(data_dir, item["vid"], fids)
        ref = reference_answer(model, frames, item["description"].lower(), fids, bucket,
                               spec.conf["config"]["INPUT"], cfg.MODEL.TEXT_MODEL.VOCAB_SIZE,
                               spec.device)
        answer = {"boxes": {f: b[0] for f, b in predictions[vid].items()},
                  "span": video_predictions[vid]["sted"]}
        b, s = gaps(answer, ref)
        box, span = max(box, b), max(span, s)
    return box, span


def control(spec):
    """box_px and span_gap of the reference in ``spec.reference_ops`` in the
    port's place, on a sample of the test split, against the float32
    reference."""
    from ..reference.model import FP32

    traffic = spec.traffic
    data_dir = spec.work.name
    corpus = generate.write_corpus(traffic, spec.seed, data_dir)
    cfg = harness.port_config(spec.conf, "DATA_DIR", data_dir)
    arch = arch_of(spec.conf["config"])
    items = {it["item_id"]: it for it in corpus["items"]}
    rng = np.random.default_rng([spec.seed % (2 ** 63), 17])
    sample = sorted(rng.choice(sorted(items), size=min(traffic["check_clips"], len(items)),
                               replace=False).tolist())
    t_in = 2 * cfg.INPUT.TRAIN_SAMPLE_NUM
    bucket = min(b for b in cfg.TPU.FRAME_BUCKETS if b >= (t_in + 1) // 2)
    with harness.exact_fp32():
        with torch.device("meta"):
            low = STCAT(arch, spec.reference_ops)
        low = low.to_empty(device=spec.device)
        low.load_state_dict(weights.draw(arch, spec.seed, spec.device))
        predictions, video_predictions = {}, {}
        for vid in sample:
            item = items[vid]
            fids = test_frame_ids(item, t_in)
            a = reference_answer(low, rinfer.decode(data_dir, item["vid"], fids),
                                 item["description"].lower(), fids, bucket,
                                 spec.conf["config"]["INPUT"], cfg.MODEL.TEXT_MODEL.VOCAB_SIZE,
                                 spec.device)
            predictions[vid] = {f: [b] for f, b in a["boxes"].items()}
            video_predictions[vid] = {"sted": a["span"]}
        del low
        ops, spec.reference_ops = spec.reference_ops, FP32
        box, span = check(spec, arch, cfg, data_dir, items, sample, predictions,
                          video_predictions)
        spec.reference_ops = ops
    return {"box_px": box, "span_gap": span}
