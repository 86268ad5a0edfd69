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

The served answers hardly see the backbone: with the benchmark's weights, a
layer4 that departs from the reference's by ten times bfloat16's rounding
moves boxes and spans no more than bfloat16 does (the draw keeps the box
head's last layer small, and the boxes move about in proportion to it). So
the window also keeps, through a forward hook on the port's body, the
layer4 features of a few requests chosen from the seed (each stream's first
and last frame), and ``layer4_gap``, the relative norm of their gap,
holds them to the reference body's on the same frames.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import generate, harness, stats, weights
from ..reference import infer as rinfer
from ..reference.model import STCAT, arch_of
from .answers import gaps, reference_answer

LATE_S = 60.0
# requests of the first half of the window whose layer4 features are kept
LAYER4_REQUESTS = 2


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
    rng = np.random.default_rng([spec.seed % (2 ** 63), 17])
    half = max(1, len(due) // 2)
    layer4 = Layer4(rng.choice(half, size=min(LAYER4_REQUESTS, half, len(due)), replace=False),
                    lengths, traffic["max_batch"])
    hook = pred.model.vis_encoder[0].body.register_forward_hook(layer4.hook)

    def timed_prepare(requests):
        with spans.span("prepare"):
            return prepare(requests)

    def timed_predict_batch(requests):
        now = time.perf_counter()
        for r in requests:
            started[id(r[2])] = now
        layer4.batch = [layer4.index.get(id(r[2])) for r in requests]
        try:
            with spans.span("predict_batch"):
                return predict_batch(requests)
        finally:
            layer4.batch = []

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
        records = offer(mb, clips, texts, due, lengths, spans, marks, t0, spec.seconds,
                        layer4.index)
        spec.sync()
    hook.remove()
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
    kept = {k: v.float().cpu() for k, v in layer4.kept.items()}
    missing = [i for i in layer4.chosen if (i, 0) not in kept]
    del mb, pred, prepare, predict_batch, timed_prepare, timed_predict_batch, layer4, hook
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with harness.exact_fp32():
        box, span, l4 = check(spec, arch, cfg, answers,
                              [(clips[i % len(clips)][:lengths[i]], texts[i]) for i in sample],
                              kept, {i: clips[i % len(clips)][:lengths[i]] for i, _ in kept})
    checks = [harness.Check("box_px", box, spec.limits["box_px"]),
              harness.Check("span_gap", span, spec.limits["span_gap"]),
              harness.Check("layer4_gap", np.inf if missing else l4, spec.limits["layer4_gap"])]
    if not sample:
        checks.append(harness.Check("finished", 0.0, -1.0))
    readings = spec.readings(kind="serve", window=(t0, t0 + spec.seconds), records=records,
                             queue_ms=queue_ms)
    return harness.Outcome(end_to_end=e2e, attempted=len(records),
                           failed=len(records) - len(finished), checks=checks,
                           memory_peak_bytes=peak, readings=readings, notes=notes)


def check(spec, arch, cfg, answers: Dict[int, Dict], inputs, kept=None, kept_clips=None):
    """(worst box_px, worst span_gap, worst layer4_gap) against the
    reference (``spec.reference_ops`` precision): of the sampled answers,
    whose (clip, sentence) pairs ``inputs`` are, and of the layer4 features
    ``kept`` by (request, stream), whose clips ``kept_clips`` holds."""
    model = _model(spec, arch)
    box = span = l4 = 0.0
    for (i, answer), (clip, text) in zip(sorted(answers.items()), inputs):
        ref = _answer(spec, cfg, model, clip, text)
        b, s = gaps(answer, ref)
        box, span = max(box, b), max(span, s)
    for (i, stream), got in sorted((kept or {}).items()):
        want = reference_layer4(spec, cfg, model, kept_clips[i], stream).cpu()
        l4 = max(l4, float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)))
    return box, span, l4


def layer4_frames(frames: int, stream: int) -> List[int]:
    """The positions, in stream ``stream`` of a clip of ``frames`` frames,
    whose layer4 features are compared: its first and last."""
    n = (frames - stream + 1) // 2
    return sorted({0, n - 1})


def reference_layer4(spec, cfg, model, clip, stream: int) -> torch.Tensor:
    """The reference body's layer4 features [k, h, w, 2048] of the frames
    ``layer4_frames`` picks from one stream of a clip."""
    inp = spec.conf["config"]["INPUT"]
    frames = torch.from_numpy(np.ascontiguousarray(clip[stream::2])).to(spec.device)
    pick = layer4_frames(clip.shape[0], stream)
    x, *_ = rinfer.model_inputs([(frames[pick], "")], len(pick), inp["RESOLUTION"],
                                inp["PIXEL_MEAN"], inp["PIXEL_STD"], inp["MAX_QUERY_LEN"],
                                cfg.MODEL.TEXT_MODEL.VOCAB_SIZE)
    with torch.no_grad():
        return model.vis_encoder[0].body(x[0])


class Layer4:
    """What the port's body makes, in the window, for the ``chosen``
    requests: a forward hook keeps the rows of their two streams at
    ``layer4_frames`` (a batch is ``lanes`` lanes of even-frame streams,
    then as many of odd-frame ones, each ``bucket`` frames) on the device.
    ``index`` maps a request's frame-id list to its index (``offer`` fills
    it); ``batch`` holds the indices of the forward under way."""

    def __init__(self, chosen, lengths, lanes: int):
        self.chosen = {int(i) for i in chosen}
        self.lengths, self.lanes = lengths, lanes
        self.index: Dict[int, int] = {}
        self.batch: List = []
        self.kept: Dict = {}

    def hook(self, module, args, out):
        for lane, i in enumerate(self.batch):
            if i in self.chosen:
                bucket = out.shape[0] // (2 * self.lanes)
                for stream in (0, 1):
                    row = (stream * self.lanes + lane) * bucket
                    self.kept[(i, stream)] = torch.stack(
                        [out[row + j] for j in layer4_frames(int(self.lengths[i]), stream)])


def _answer(spec, cfg, model, clip, text) -> Dict:
    """The reference's answer to a whole clip, its streams padded to the
    smallest frame bucket that holds them."""
    frames = clip.shape[0]
    bucket = min(b for b in cfg.TPU.FRAME_BUCKETS if b >= (frames + 1) // 2)
    return reference_answer(model, clip, text, list(range(frames)), bucket,
                            spec.conf["config"]["INPUT"], cfg.MODEL.TEXT_MODEL.VOCAB_SIZE,
                            spec.device)


def offer(mb, clips, texts, due, lengths, spans, marks, t0, seconds, index=None) -> List[Dict]:
    """Submit a request of lengths[i] frames at each arrival time t0 +
    due[i], then wait until the window's end and up to LATE_S more for the
    answers. Each record has its due, sent and done times and its answer or
    error; ``index`` (if given) maps id(frame-id list) -> i."""
    records: List[Dict] = []
    for i, d in enumerate(due):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            with spans.span("idle"):
                time.sleep(wait)
        frames = int(lengths[i])
        rec = {"due": t0 + d, "sent": time.perf_counter(), "fids": list(range(frames)),
               "done": None}
        if index is not None:
            index[id(rec["fids"])] = i
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
    """box_px, span_gap and layer4_gap of the reference in
    ``spec.reference_ops`` in the port's place, on requests of the mix,
    against the float32 reference."""
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
        kept = {(i, s): reference_layer4(spec, cfg, low, inputs[i][0], s).cpu()
                for i in range(min(LAYER4_REQUESTS, n)) for s in (0, 1)}
        del low
        ops, spec.reference_ops = spec.reference_ops, FP32
        box, span, l4 = check(spec, arch, cfg, answers, inputs, kept,
                              {i: clip for i, (clip, _) in enumerate(inputs)})
        spec.reference_ops = ops
    return {"box_px": box, "span_gap": span, "layer4_gap": l4}


def _model(spec, arch):
    with torch.device("meta"):
        model = STCAT(arch, spec.reference_ops)
    model = model.to_empty(device=spec.device)
    model.load_state_dict(weights.draw(arch, spec.seed, spec.device))
    return model
