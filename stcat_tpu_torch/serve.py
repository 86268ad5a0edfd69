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

A request's own host work (``GroundingPredictor.stage``: checks, stream
split, plans, tokens, and each stream's frames written once on a canvas of
their own, in page-locked memory when serving on a card) runs when
``MicroBatcher.submit`` takes it, on a staging thread, while the card serves
the groups ahead; a direct ``predict``/``predict_batch`` call stages in
``prepare``. ``place`` then allocates the batch's frame tensor on the
device and fills it by non-blocking copies from the staged canvases.

Spans (``core/trace.py``; ``trace.enable()`` turns them on,
``trace.drain()`` collects them). Each submitted request gets an id, and a
``serve.stage`` span (``attrs["request"]``) on the staging thread
``stcat-stage_0``. The dispatcher thread, named
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
counters count recorder on or off: ``serve.forwards`` the forwards
``predict_batch`` launches, one per group of at most max_batch requests;
per request ``prepare`` takes, ``serve.staged_ready`` those staged by
``submit`` whose staging was done when ``prepare`` began,
``serve.staged_waited`` those it waited for, and ``serve.unstaged`` those of
direct calls.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core import trace
from .core.batch import RawVideoBatch, to_device
from .data.batching import (SRC_CANVAS_QUANT, assemble_raw_batch, pick_bucket, place_canvas,
                            raw_canvases, round_up)
from .data.tokenize import build_tokenizer, check_tokenizer_for_weights
from .data.transforms import build_transforms
from .eval.engine import merge_two_streams, orig_sizes, to_host
from .models import build_model
from .models.postprocess import postprocess
from .ops.misc import resolve_device
from .train.checkpoint import load_weights_for_eval
from .train.step import make_eval_forward


DISPATCHER = "stcat-microbatcher"
STAGER = "stcat-stage"
FORWARDS = trace.Counter("serve.forwards")
STAGED_READY = trace.Counter("serve.staged_ready")
STAGED_WAITED = trace.Counter("serve.staged_waited")
UNSTAGED = trace.Counter("serve.unstaged")


def eval_forward(cfg, model, raw: RawVideoBatch) -> Dict[str, torch.Tensor]:
    """On-device preprocess + STCATNet forward of a host-stacked raw batch;
    returns the postprocess inputs."""
    return make_eval_forward(cfg, model, device_split=False)(raw)


class Request(tuple):
    """A request as ``MicroBatcher.submit`` queues it: the (frames, text,
    frame_ids) tuple predict_batch takes, and ``staged``, the Future of its
    ``GroundingPredictor.stage`` on the batcher's staging thread."""

    staged: Future

    def __new__(cls, frames, text, frame_ids):
        return super().__new__(cls, (frames, text, frame_ids))


@dataclasses.dataclass
class Staged:
    """A request's host work that its lane-mates do not change: its even and
    odd streams as raw samples (``frames_u8`` a [t, h, w, 3] view of
    ``canvas``, the stream's frames as ``place_canvas`` lays them out on a
    canvas of their own, page-locked when the predictor serves on a card)
    and its sentence's tokens, [1, MAX_QUERY_LEN] each."""

    streams: Tuple[Dict, Dict]
    token_ids: np.ndarray
    token_valid: np.ndarray


@dataclasses.dataclass
class StagedFrames:
    """A prepared batch's frames, still on the host: row b's staged canvas
    ``rows[b]`` and its frames' (h, w) ``sizes[b]``, for a device tensor of
    ``shape`` [B, T, Hs, Ws, 3]."""

    rows: List[torch.Tensor]
    sizes: List[Tuple[int, int]]
    shape: Tuple[int, int, int, int, int]

    def place(self, device) -> torch.Tensor:
        """The frames as ``build_raw_batch`` lays them out, in a tensor
        allocated on ``device``: each row copied from its canvas
        (``non_blocking``: from page-locked memory the host goes on, and
        torch's caching host allocator keeps the canvas until the copy is
        done), a row whose canvas an earlier row took (a replica lane, a
        one-frame clip's second stream) copied from that row on the device,
        and the frames past a row's length zeroed there."""
        out = torch.empty(self.shape, dtype=torch.uint8, device=device)
        hs, ws = self.shape[2:4]
        for b, src in enumerate(self.rows):
            first = next(j for j in range(b + 1) if self.rows[j] is src)
            if first < b:
                out[b].copy_(out[first])
                continue
            t, hc, wc = src.shape[:3]
            out[b, t:].zero_()
            if (hc, wc) == (hs, ws):
                out[b, :t].copy_(src, non_blocking=True)
                continue
            # a canvas smaller than the batch's: zero around it and replicate
            # the boundary row and column against the batch's canvas
            lane = out[b, :t]
            lane[:, :hc, :wc].copy_(src, non_blocking=True)
            lane[:, hc:].zero_()
            lane[:, :hc, wc:].zero_()
            h, w = self.sizes[b]
            if h < hs:
                lane[:, h, :w] = lane[:, h - 1, :w]
            if w < ws:
                lane[:, : min(h + 1, hs), w] = lane[:, : min(h + 1, hs), w - 1]
        return out


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

    def _stream(self, frames: np.ndarray, text: str, fids) -> Dict:
        t, h, w = frames.shape[:3]
        plan, _, text = self.transform.plan((h, w), np.zeros((0, 4), np.float32), text)
        canvas = torch.empty((t, round_up(h, SRC_CANVAS_QUANT), round_up(w, SRC_CANVAS_QUANT), 3),
                             dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        place_canvas(canvas.numpy(), frames)
        return {"frames_u8": canvas[:, :h, :w], "canvas": canvas, "plan": plan, "text": text,
                "frame_ids": list(fids), "ori_size": (h, w), "pad": False}

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
                    placed = self.place(raw)
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

    def stage(self, request) -> Staged:
        """The host work of one request (frames, text, frame_ids) that no
        lane-mate changes: its checks, the even/odd stream split, each
        stream's plan and canvas, and its tokens (padded to MAX_QUERY_LEN).
        ``MicroBatcher.submit`` runs it as the request arrives; ``prepare``
        runs it for a request that was not staged."""
        frames, text = np.asarray(request[0]), request[1]
        fids = request[2] if len(request) > 2 else None
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"frames must be [T,H,W,3], got {frames.shape}")
        if frames.dtype != np.uint8:
            raise ValueError("frames must be uint8 RGB")
        t = frames.shape[0]
        fids = list(range(t)) if fids is None else list(fids)
        if len(fids) != t:
            raise ValueError(f"{len(fids)} frame_ids for {t} frames")
        if t >= 2:
            streams = (self._stream(frames[0::2], text, fids[0::2]),
                       self._stream(frames[1::2], text, fids[1::2]))
        else:  # degenerate single-frame clip: duplicate the stream
            even = self._stream(frames, text, fids)
            streams = (even, dict(even, pad=True))
        ids, valid = self.tokenizer([streams[0]["text"]], self.cfg.INPUT.MAX_QUERY_LEN)
        return Staged(streams, ids, valid)

    def prepare(self, requests) -> Tuple[RawVideoBatch, List[Dict], List[Dict]]:
        """Host side of predict_batch for at most max_batch requests: the
        stacked raw batch (its frames ``StagedFrames``, for ``place``; the
        rest numpy) and the meta of its even and odd streams. A request that
        ``MicroBatcher.submit`` staged is waited for (``serve.staged_ready``
        counts those whose staging was done when this began,
        ``serve.staged_waited`` the others); any other is staged here
        (``serve.unstaged``)."""
        if len(requests) > self.max_batch:
            raise ValueError(f"{len(requests)} requests for {self.max_batch} lanes")
        futures = [getattr(r, "staged", None) for r in requests]
        ready = [f is not None and f.done() for f in futures]
        lanes = []
        for r, fut, done in zip(requests, futures, ready):
            if fut is None:
                UNSTAGED.add()
                lanes.append(self.stage(r))
            else:
                (STAGED_READY if done else STAGED_WAITED).add()
                lanes.append(fut.result())
        n_real = len(lanes)
        lanes += [lanes[0]] * (self.max_batch - n_real)  # fixed lane count: pad with replicas
        rows = [dict(lane.streams[k], item_id=i, pad=lane.streams[k]["pad"] or i >= n_real)
                for k in (0, 1) for i, lane in enumerate(lanes)]

        t_bucket = pick_bucket(max(r["frames_u8"].shape[0] for r in rows),
                               self.cfg.TPU.FRAME_BUCKETS)
        (hs, ws), _ = raw_canvases(rows)
        frames = StagedFrames([r["canvas"] for r in rows], [r["ori_size"] for r in rows],
                              (len(rows), t_bucket, hs, ws, 3))
        ids = np.concatenate([lane.token_ids for lane in lanes] * 2)
        valid = np.concatenate([lane.token_valid for lane in lanes] * 2)
        raw, _, meta = assemble_raw_batch(rows, t_bucket, ids, valid, frames_u8=frames)
        return raw, meta[: len(lanes)], meta[len(lanes):]

    def place(self, raw: RawVideoBatch) -> RawVideoBatch:
        """A prepared batch on the predictor's device: the frames first, in
        a tensor allocated there (``StagedFrames.place``), then the small
        arrays."""
        frames = raw.frames_u8.place(self.device)
        placed = to_device(dataclasses.replace(raw, frames_u8=None), self.device)
        return dataclasses.replace(placed, frames_u8=frames)


class MicroBatcher:
    """Groups concurrent submit() calls into stacked device batches.

    ``submit`` hands each request to one staging thread (named
    ``stcat-stage_0``), which runs ``predictor.stage`` on it while the card
    serves the groups ahead, and queues it at once. One dispatcher thread
    (named ``stcat-microbatcher``) drains the queue, waits up to max_wait_ms
    for lane-mates, and runs predictor.predict_batch, whose ``prepare``
    waits for the group's staging; errors, of the staging too, reach every
    caller of the failed group through its Future. Each request is queued
    with its id and its submit time (``perf_counter_ns``) for the module's
    spans.
    """

    def __init__(self, predictor: GroundingPredictor, max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0):
        self.predictor = predictor
        self.max_batch = max_batch or predictor.max_batch
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._ids = itertools.count()
        self._stager = ThreadPoolExecutor(1, thread_name_prefix=STAGER)
        self._thread = threading.Thread(target=self._run, daemon=True, name=DISPATCHER)
        self._thread.start()

    def submit(self, frames: np.ndarray, text: str,
               frame_ids: Optional[Sequence[int]] = None) -> Future:
        """Queue a request and return its Future at once: its staging runs
        on the staging thread."""
        submitted, rid = time.perf_counter_ns(), next(self._ids)
        fut: Future = Future()
        req = Request(frames, text, frame_ids)
        req.staged = self._stager.submit(self._stage, req, rid)
        self._q.put((fut, req, rid, submitted))
        return fut

    def _stage(self, req: Request, rid: int) -> Staged:
        with trace.span("serve.stage", request=rid):
            return self.predictor.stage(req)

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
        self._stager.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
