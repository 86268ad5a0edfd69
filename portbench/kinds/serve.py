"""The serving cell: ``MicroBatcher(GroundingPredictor(max_batch), max_wait_ms)``
as ``cli/serve.py`` builds it, driven through ``submit`` by an open loop.

Set-up loads the benchmark's weights into the predictor and serves a few
requests of each of the mix's lengths. The window offers one request at
each arrival time of the mix (``generate.arrivals``): a clip from the pool
cut to the request's length (``generate.request_lengths``) and a sentence,
timed from when it was due to when its Future was done. Requests still
open when the window closes get a minute more; one that fails or never
finishes counts as missing. Once all are in, the port is freed and the
reference answers a sample of the finished requests, drawn from the seed,
on the same frames and sentences.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import generate, harness, stats, weights
from ..reference.model import STCAT, arch_of
from .answers import gaps, reference_answer

LATE_S = 60.0


def run(spec) -> harness.Outcome:
    from stcat_tpu_torch.serve import GroundingPredictor, MicroBatcher

    dev, traffic, spans = spec.device, spec.traffic, spec.spans
    cfg = harness.port_config(spec.conf)
    arch = arch_of(spec.conf["config"])
    clips = generate.request_clips(traffic, spec.seed)
    due = generate.arrivals(traffic, spec.seconds, spec.seed)
    lengths = generate.request_lengths(traffic, len(due), spec.seed)
    texts = generate.sentences(traffic, spec.seed, len(due) + 4)
    pred = GroundingPredictor(cfg, max_batch=traffic["max_batch"], device=dev,
                              state_dict=weights.draw(arch, spec.seed, dev))
    started: Dict[int, float] = {}
    prepare, predict_batch = pred.prepare, pred.predict_batch

    def timed_prepare(requests):
        with spans.span("prepare"):
            return prepare(requests)

    def timed_predict_batch(requests):
        now = time.perf_counter()
        for r in requests:
            started[id(r[2])] = now
        with spans.span("predict_batch"):
            return predict_batch(requests)

    pred.prepare, pred.predict_batch = timed_prepare, timed_predict_batch
    with MicroBatcher(pred, max_wait_ms=traffic["max_wait_ms"]) as mb:
        # warm-up: a request alone and a full group, of each of the window's lengths
        for frames in generate.length_set(traffic):
            for group in (1, traffic["max_batch"]):
                futs = [mb.submit(clips[k % len(clips)][:frames], texts[-1 - k],
                                  list(range(frames))) for k in range(group)]
                for f in futs:
                    f.result(timeout=1200)
        spec.sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        spec.setup_done(t0)
        marks = spec.start_trace(t0)
        records = offer(mb, clips, texts, due, lengths, spans, marks, t0, spec.seconds)
        spec.sync()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lat = [(r["done"] - r["due"]) * 1e3 if "answer" in r and r["done"] is not None else np.inf
           for r in records]
    q = traffic["tail"]
    e2e = {f"serve_p{q}_ms": stats.percentile(lat, q)}
    finished = [i for i, r in enumerate(records) if "answer" in r]
    rng = np.random.default_rng([spec.seed % (2 ** 63), 13])
    sample = sorted(rng.choice(finished, size=min(traffic["check_requests"], len(finished)),
                               replace=False).tolist())
    answers = {i: records[i]["answer"] for i in sample}
    queue_ms = [(started[id(r["fids"])] - r["due"]) * 1e3 for r in records
                if id(r["fids"]) in started]
    notes = {"requests": len(records), "finished": len(finished), "percentile": q,
             "median_ms": stats.percentile(lat, 50), "sent_late_ms_max":
             max((r["sent"] - r["due"]) * 1e3 for r in records) if records else 0.0,
             "errors": sorted({r["error"] for r in records if "error" in r})[:3]}
    del mb, pred, prepare, predict_batch, timed_prepare, timed_predict_batch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with harness.exact_fp32():
        box, span = check(spec, arch, cfg, answers,
                          [(clips[i % len(clips)][:lengths[i]], texts[i]) for i in sample])
    checks = [harness.Check("box_px", box, spec.limits["box_px"]),
              harness.Check("span_gap", span, spec.limits["span_gap"])]
    if not sample:
        checks.append(harness.Check("finished", 0.0, -1.0))
    readings = spec.readings(kind="serve", window=(t0, t0 + spec.seconds), records=records,
                             queue_ms=queue_ms)
    return harness.Outcome(end_to_end=e2e, attempted=len(records),
                           failed=len(records) - len(finished), checks=checks,
                           memory_peak_bytes=peak, readings=readings, notes=notes)


def check(spec, arch, cfg, answers: Dict[int, Dict], inputs):
    """(worst box_px, worst span_gap) of the sampled answers against the
    reference (``spec.reference_ops`` precision); ``inputs`` are their
    (clip, sentence) pairs."""
    model = _model(spec, arch)
    box = span = 0.0
    for (i, answer), (clip, text) in zip(sorted(answers.items()), inputs):
        ref = _answer(spec, cfg, model, clip, text)
        b, s = gaps(answer, ref)
        box, span = max(box, b), max(span, s)
    return box, span


def _answer(spec, cfg, model, clip, text) -> Dict:
    """The reference's answer to a whole clip, its streams padded to the
    smallest frame bucket that holds them."""
    frames = clip.shape[0]
    bucket = min(b for b in cfg.TPU.FRAME_BUCKETS if b >= (frames + 1) // 2)
    return reference_answer(model, clip, text, list(range(frames)), bucket,
                            spec.conf["config"]["INPUT"], cfg.MODEL.TEXT_MODEL.VOCAB_SIZE,
                            spec.device)


def offer(mb, clips, texts, due, lengths, spans, marks, t0, seconds) -> List[Dict]:
    """Submit a request of lengths[i] frames at each arrival time t0 +
    due[i], then wait until the window's end and up to LATE_S more for the
    answers. Each record has its due, sent and done times and its answer or
    error."""
    records: List[Dict] = []
    for i, d in enumerate(due):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            with spans.span("idle"):
                time.sleep(wait)
        frames = int(lengths[i])
        rec = {"due": t0 + d, "sent": time.perf_counter(), "fids": list(range(frames)),
               "done": None}
        rec["future"] = mb.submit(clips[i % len(clips)][:frames], texts[i], rec["fids"])
        rec["future"].add_done_callback(lambda f, rec=rec: rec.__setitem__(
            "done", time.perf_counter()))
        records.append(rec)
        marks.tick(i)
    t_end = t0 + seconds
    while time.perf_counter() < t_end:
        marks.tick(len(records))
        time.sleep(min(0.05, max(0.0, t_end - time.perf_counter())))
    marks.close(len(records), t_end)
    deadline = t_end + LATE_S
    for rec in records:
        try:
            rec["answer"] = rec["future"].result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception as e:  # boundary: a failed or late request counts as missing
            rec["error"] = f"{type(e).__name__}: {e}"
    return records


def sweep(spec, rates, seconds: float) -> List[Dict]:
    """One predictor, an open-loop window per rate: the latency quartiles,
    the tail and how many requests were still open when the window closed."""
    from stcat_tpu_torch.serve import GroundingPredictor, MicroBatcher

    from ..run import Marks

    traffic = spec.traffic
    cfg = harness.port_config(spec.conf)
    arch = arch_of(spec.conf["config"])
    clips = generate.request_clips(traffic, spec.seed)
    texts = generate.sentences(traffic, spec.seed, int(max(rates) * seconds) + 8)
    pred = GroundingPredictor(cfg, max_batch=traffic["max_batch"], device=spec.device,
                              state_dict=weights.draw(arch, spec.seed, spec.device))
    out = []
    with MicroBatcher(pred, max_wait_ms=traffic["max_wait_ms"]) as mb:
        for frames in generate.length_set(traffic):
            for k in range(traffic["max_batch"]):
                mb.submit(clips[k % len(clips)][:frames], texts[k],
                          list(range(frames))).result(timeout=1200)
        for rate in rates:
            due = generate.arrivals(traffic, seconds, spec.seed, rate)
            lengths = generate.request_lengths(traffic, len(due), spec.seed)
            t0 = time.perf_counter()
            records = offer(mb, clips, texts, due, lengths, spec.spans,
                            Marks(None, t0, seconds), t0, seconds)
            lat = [(r["done"] - r["due"]) * 1e3 if "answer" in r else np.inf for r in records]
            third = max(1, len(lat) // 3)
            out.append({"rate": rate, "requests": len(records),
                        "open_at_end": sum(1 for r in records
                                           if r["done"] is None or r["done"] > t0 + seconds),
                        "p50_ms": stats.percentile(lat, 50), "p90_ms": stats.percentile(lat, 90),
                        "first_third_mean_ms": float(np.mean(lat[:third])),
                        "last_third_mean_ms": float(np.mean(lat[-third:]))})
    return out


def control(spec) -> Dict[str, float]:
    """box_px and span_gap of the reference in ``spec.reference_ops`` in the
    port's place, on requests of the mix, against the float32 reference."""
    from ..reference.model import FP32

    traffic = spec.traffic
    cfg = harness.port_config(spec.conf)
    arch = arch_of(spec.conf["config"])
    clips = generate.request_clips(traffic, spec.seed)
    n = traffic["check_requests"]
    texts = generate.sentences(traffic, spec.seed, n)
    lengths = generate.request_lengths(traffic, n, spec.seed)
    inputs = [(clips[i % len(clips)][:lengths[i]], texts[i]) for i in range(n)]
    with harness.exact_fp32():
        low = _model(spec, arch)
        answers = {i: _answer(spec, cfg, low, clip, text) for i, (clip, text) in enumerate(inputs)}
        del low
        ops, spec.reference_ops = spec.reference_ops, FP32
        box, span = check(spec, arch, cfg, answers, inputs)
        spec.reference_ops = ops
    return {"box_px": box, "span_gap": span}


def _model(spec, arch):
    with torch.device("meta"):
        model = STCAT(arch, spec.reference_ops)
    model = model.to_empty(device=spec.device)
    model.load_state_dict(weights.draw(arch, spec.seed, spec.device))
    return model
