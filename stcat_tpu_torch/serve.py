"""Online inference: a load-once predictor and a micro-batching request queue.

    pred = GroundingPredictor(cfg, "out/run", max_batch=2)  # cuda by default
    result = pred.predict(frames_u8, "a person waves")      # one request
    with MicroBatcher(pred) as mb:                           # concurrent callers
        result = mb.submit(frames_u8, "a person waves").result()

``result`` is {"boxes": {frame_id: [x1, y1, x2, y2]}, "span": [start, end+1]}
with boxes in ORIGINAL pixel coordinates and the span in frame-id units.
Each request is split into its even and odd frame streams; the device batch
holds 2R lanes (R = max_batch; short request lists are padded with replica
lanes that are decoded away), preprocessed on the device, run through
STCATNet, postprocessed, and merged back to the full frame rate.

Spans (``core/trace.py``; ``trace.enable()`` turns them on,
``trace.drain()`` collects them). Each submitted request gets an id. The
dispatcher thread, named
``stcat-microbatcher``, records per group ``serve.group`` (from taking its
first request to closing it, the ``max_wait_ms`` wait included) and
``serve.dispatch`` around ``predict_batch`` (``attrs["requests"]``: the
group's ids), then one ``serve.queued`` per request, from its submit to the
start of its ``serve.dispatch``. ``predict_batch`` records ``serve.batch``
(``attrs`` ``real`` and ``lanes``: the requests and the padded lanes), a
child of ``serve.dispatch`` under a MicroBatcher, holding ``serve.prepare``
(host prep), ``serve.h2d`` (the copies to the device), ``serve.forward``
(the forward's host enqueue; ``attrs`` ``rows``, the lanes x streams x bucket
frames it runs, ``canvas``, their [H, W], and ``backbone_hw``, the
backbone's output [h, w]), ``serve.postprocess``, ``serve.readback``
(the one wait for the card) and ``serve.merge`` (the stream merge and the
result dicts). ``cli/serve.py --trace`` serves them at ``GET /trace``. The
counter ``serve.forwards`` counts the forwards ``predict_batch`` launches,
one per group of at most max_batch requests, recorder on or off.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core import trace
from .core.batch import RawVideoBatch, to_device
from .data.batching import build_raw_batch, pick_bucket
from .data.tokenize import build_tokenizer, check_tokenizer_for_weights
from .data.transforms import build_transforms
from .eval.engine import merge_two_streams, orig_sizes, to_host
from .models import build_model
from .models.postprocess import postprocess
from .ops.misc import resolve_device
from .train.checkpoint import load_weights_for_eval
from .train.step import make_eval_forward


DISPATCHER = "stcat-microbatcher"
FORWARDS = trace.Counter("serve.forwards")


def eval_forward(cfg, model, raw: RawVideoBatch) -> Dict[str, torch.Tensor]:
    """On-device preprocess + STCATNet forward of a host-stacked raw batch;
    returns the postprocess inputs."""
    return make_eval_forward(cfg, model, device_split=False)(raw)


class GroundingPredictor:
    """Owns the model, weights, tokenizer and device.

    ``weights`` (else MODEL.WEIGHT): a reference-named torch file, a training
    run's checkpoint directory (EMA weights preferred) or a converted
    checkpoint directory (``cli/convert.py``), loaded and logged through
    ``logger``; the tokenizer guard checks that path. ``state_dict``: a port
    state_dict to load instead (e.g. from ``convert.from_jax_variables``), with
    no path to guard; it cannot be combined with ``weights``. With neither, the
    fresh init drawn from ``seed`` stays. predict() is thread-safe (calls
    serialize on a lock); use MicroBatcher to batch concurrent requests.
    """

    def __init__(self, cfg, weights: str = "", logger=None, max_batch: int = 1, device=None,
                 seed: int = 0, state_dict: Optional[Dict[str, torch.Tensor]] = None):
        if weights and state_dict is not None:
            raise ValueError("GroundingPredictor: pass weights or state_dict, not both")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max(1, int(max_batch))
        self.tokenizer = build_tokenizer(cfg)
        path = weights or cfg.MODEL.WEIGHT
        if state_dict is None:
            check_tokenizer_for_weights(cfg, self.tokenizer, path, what="inference")
        self.transform = build_transforms(cfg)
        self.model = build_model(cfg, self.device, seed)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        else:
            load_weights_for_eval(self.model, path, logger)
        self._lock = threading.Lock()

    def _raw_sample(self, frames: np.ndarray, text: str, item_id, fids, pad: bool) -> Dict:
        h, w = frames.shape[1:3]
        plan, _, text = self.transform.plan((h, w), np.zeros((0, 4), np.float32), text)
        return {"frames_u8": np.ascontiguousarray(frames), "plan": plan, "text": text,
                "item_id": item_id, "frame_ids": list(fids), "ori_size": (h, w), "pad": pad}

    def predict(self, frames: np.ndarray, text: str,
                frame_ids: Optional[Sequence[int]] = None) -> Dict:
        """One clip: frames uint8 [T, H, W, 3] (RGB) and a sentence."""
        return self.predict_batch([(frames, text, frame_ids)])[0]

    def predict_batch(self, requests: List[Tuple[np.ndarray, str, Optional[Sequence[int]]]]
                      ) -> List[Dict]:
        """Up to max_batch requests in one stacked two-stream forward: rows
        [0, R) are the even-frame streams, rows [R, 2R) the odd-frame ones."""
        if not requests:
            return []
        if len(requests) > self.max_batch:
            out = []
            for i in range(0, len(requests), self.max_batch):
                out.extend(self.predict_batch(requests[i: i + self.max_batch]))
            return out

        with trace.span("serve.batch") as batch:
            with trace.span("serve.prepare"):
                raw, m1, m2 = self.prepare(requests)
            batch.note(real=sum(1 for m in m1 if not m["pad"]), lanes=len(m1))
            with self._lock, torch.inference_mode():
                with trace.span("serve.h2d"):
                    placed = to_device(raw, self.device)
                    sizes = to_device(orig_sizes(m1 + m2), self.device)
                attrs = self._forward_attrs(raw) if trace.enabled() else {}
                with trace.span("serve.forward", **attrs):
                    out = eval_forward(self.cfg, self.model, placed)
                FORWARDS.add()
                with trace.span("serve.postprocess"):
                    boxes, s_idx, e_idx = postprocess(out["pred_boxes"], out["pred_sted"], sizes,
                                                      placed.frame_valid)
                with trace.span("serve.readback"):
                    boxes, s_idx, e_idx = to_host((boxes, s_idx, e_idx))
            with trace.span("serve.merge"):
                bbox_pred, temp_pred = merge_two_streams(boxes, s_idx, e_idx, raw.frame_valid,
                                                         m1, m2)
                return [
                    {"boxes": {fid: bb[0] for fid, bb in bbox_pred[i].items()},
                     "span": temp_pred[i]["sted"]}
                    for i in range(len(requests))
                ]

    def _forward_attrs(self, raw: RawVideoBatch) -> Dict:
        """``serve.forward``'s attrs: the frames the forward runs, their
        canvas and the backbone's output size on it."""
        h, w = (int(n) for n in raw.out_canvas)
        rows = raw.frame_valid.shape[0] * raw.frame_valid.shape[1]
        stride = self.model.vis_encoder[0].body.stride
        return {"rows": int(rows), "canvas": [h, w],
                "backbone_hw": [-(-h // stride), -(-w // stride)]}

    def prepare(self, requests) -> Tuple[RawVideoBatch, List[Dict], List[Dict]]:
        """Host side of predict_batch for at most max_batch requests: the
        stacked raw batch (numpy) and the meta of its even and odd streams."""
        if len(requests) > self.max_batch:
            raise ValueError(f"{len(requests)} requests for {self.max_batch} lanes")
        reqs = list(requests)
        n_real = len(reqs)
        while len(reqs) < self.max_batch:  # fixed lane count: pad with replicas
            reqs.append(reqs[0])

        s0, s1 = [], []
        for i, item in enumerate(reqs):
            frames, text = np.asarray(item[0]), item[1]
            fids = item[2] if len(item) > 2 and item[2] is not None else None
            if frames.ndim != 4 or frames.shape[-1] != 3:
                raise ValueError(f"frames must be [T,H,W,3], got {frames.shape}")
            if frames.dtype != np.uint8:
                raise ValueError("frames must be uint8 RGB")
            t = frames.shape[0]
            fids = list(range(t)) if fids is None else list(fids)
            if len(fids) != t:
                raise ValueError(f"{len(fids)} frame_ids for {t} frames")
            pad = i >= n_real
            if t >= 2:
                s0.append(self._raw_sample(frames[0::2], text, i, fids[0::2], pad))
                s1.append(self._raw_sample(frames[1::2], text, i, fids[1::2], pad))
            else:  # degenerate single-frame clip: duplicate the stream
                s0.append(self._raw_sample(frames, text, i, fids, pad))
                s1.append(self._raw_sample(frames, text, i, fids, True))

        t_bucket = pick_bucket(max(s["frames_u8"].shape[0] for s in s0 + s1),
                               self.cfg.TPU.FRAME_BUCKETS)
        raw, _, meta = build_raw_batch(s0 + s1, t_bucket, self.tokenizer,
                                       self.cfg.INPUT.MAX_QUERY_LEN)
        return raw, meta[: len(s0)], meta[len(s0):]


class MicroBatcher:
    """Groups concurrent submit() calls into stacked device batches.

    One dispatcher thread (named ``stcat-microbatcher``) drains the queue,
    waits up to max_wait_ms for lane-mates, and runs
    predictor.predict_batch; errors reach every caller of the failed group
    through its Future. Each request is queued with its id and its submit
    time (``perf_counter_ns``) for the module's spans.
    """

    def __init__(self, predictor: GroundingPredictor, max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0):
        self.predictor = predictor
        self.max_batch = max_batch or predictor.max_batch
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._ids = itertools.count()
        self._thread = threading.Thread(target=self._run, daemon=True, name=DISPATCHER)
        self._thread.start()

    def submit(self, frames: np.ndarray, text: str,
               frame_ids: Optional[Sequence[int]] = None) -> Future:
        fut: Future = Future()
        self._q.put((fut, (frames, text, frame_ids), next(self._ids), time.perf_counter_ns()))
        return fut

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            with trace.span("serve.group"):
                group = [first]
                deadline = time.monotonic() + self.max_wait
                while len(group) < self.max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        group.append(self._q.get(timeout=left))
                    except queue.Empty:
                        break
            futs, reqs, ids, submitted = zip(*group)
            with trace.span("serve.dispatch", requests=list(ids)) as dispatch:
                try:
                    results = self.predictor.predict_batch(list(reqs))
                    for fut, res in zip(futs, results):
                        fut.set_result(res)
                except Exception as e:  # boundary: every caller in the group gets the error
                    for fut in futs:
                        if not fut.done():
                            fut.set_exception(e)
            if dispatch.start is not None:
                for rid, t in zip(ids, submitted):
                    trace.record("serve.queued", t, dispatch.start, request=rid)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
