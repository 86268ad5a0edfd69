"""Evaluation: two-stream temporal supersampling and the eval loop.

Test clips are sampled at twice the train frame rate and split into their
even and odd frame streams, which run through the model as one stacked
batch of 2B clips; the per-frame boxes of the two streams are merged and
linearly interpolated back to the full frame rate, and the span is the
min/max envelope of the two streams' spans. Everything after postprocess
is host-side python on small numpy arrays.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List

import numpy as np
import torch

from ..core import trace
from ..core.batch import stack_streams, subsample_stream
from ..core.dist import is_main_process, synchronize
from ..core.mesh import local_batch
from ..core.prefetch import prefetch_to_device
from ..models.postprocess import postprocess
from ..train.step import eval_device_split_active, make_eval_forward

# device-to-host reads wait until this many stacked batches are in flight
PIPELINE_DEPTH = 2


def linear_interp_boxes(bbox_dict: Dict[int, List[List[float]]]) -> Dict:
    """Fill frame-id gaps by linear interpolation."""
    fids = sorted(bbox_dict)
    if len(fids) < 2:
        return bbox_dict
    for a, b in zip(fids[:-1], fids[1:]):
        gap = b - a
        if gap > 1:
            left = np.asarray(bbox_dict[a][0], np.float64)
            right = np.asarray(bbox_dict[b][0], np.float64)
            delta = (right - left) / gap
            for s in range(1, gap):
                bbox_dict[a + s] = [(left + s * delta).tolist()]
    return {fid: bbox_dict[fid] for fid in sorted(bbox_dict)}


def _decode_rows(boxes, s_idx, e_idx, frame_valid, meta, row0):
    """Rows [row0, row0+len(meta)) of a postprocessed batch -> pred dicts,
    skipping filler rows (meta['pad'])."""
    bbox_pred, temp_pred = {}, {}
    for j, m in enumerate(meta):
        if m.get("pad"):
            continue
        i = row0 + j
        fids = m["frame_ids"]
        n = int(np.asarray(frame_valid[i]).sum())
        if n != len(fids):
            raise ValueError(f"row {i}: {n} valid frames for {len(fids)} frame ids")
        bbox_pred[m["item_id"]] = {fids[k]: [boxes[i, k].tolist()] for k in range(n)}
        temp_pred[m["item_id"]] = {
            "sted": [fids[int(s_idx[i])], fids[int(e_idx[i])] + 1],
            "qtype": m.get("qtype", "none"),
        }
    return bbox_pred, temp_pred


def merge_two_streams(boxes, s_idx, e_idx, frame_valid, m1, m2):
    """Union the two streams' per-frame boxes, interpolate the gaps, and take
    the min/max envelope of their spans. Rows [0, len(m1)) are stream 0,
    the next len(m2) rows stream 1. An item whose stream-1 row is padding
    (a served single-frame clip) keeps its stream-0 prediction."""
    bbox1, temp1 = _decode_rows(boxes, s_idx, e_idx, frame_valid, m1, 0)
    bbox2, temp2 = _decode_rows(boxes, s_idx, e_idx, frame_valid, m2, len(m1))
    bbox_pred, temp_pred = {}, {}
    for vid in bbox1:
        if vid not in bbox2:
            bbox_pred[vid], temp_pred[vid] = bbox1[vid], temp1[vid]
            continue
        bbox1[vid].update(bbox2[vid])
        bbox_pred[vid] = linear_interp_boxes(bbox1[vid])
        temp_pred[vid] = {
            "sted": [min(temp1[vid]["sted"][0], temp2[vid]["sted"][0]),
                     max(temp1[vid]["sted"][1], temp2[vid]["sted"][1])],
            "qtype": temp1[vid].get("qtype", "none"),
        }
    return bbox_pred, temp_pred


def subsample_batch(batch, meta: List[Dict], start: int):
    """The even (0) or odd (1) frame stream of a batch and its meta."""
    return (subsample_stream(batch, start),
            [{**m, "frame_ids": m["frame_ids"][start::2]} for m in meta])


def orig_sizes(meta: List[Dict]) -> np.ndarray:
    """[rows, 2] int32 (h, w) of each row's original frames: the host array
    that crosses to the device with its batch."""
    return np.asarray([m["ori_size"] for m in meta], np.int32).reshape(-1, 2)


def eval_inputs(batch, meta: List[Dict], device_split: bool):
    """The host side of one eval batch: (the forward's input -- the batch
    itself with the device split, else its two streams stacked --, the
    rows' original sizes, the two streams' meta)."""
    b1, m1 = subsample_batch(batch, meta, 0)
    b2, m2 = subsample_batch(batch, meta, 1)
    return (batch if device_split else stack_streams(b1, b2)), orig_sizes(m1 + m2), m1, m2


def to_host(tensors) -> List[np.ndarray]:
    """The drain's device-to-host read, the one place do_eval waits for the
    card (the JAX engine's device_get)."""
    return [t.cpu().numpy() for t in tensors]


def do_eval(cfg, model, loader, evaluator, logger=None):
    """A full evaluation pass of ``model`` (on its device) over ``loader``'s
    batches (raw, or host-transformed); returns ``evaluator.summarize()``.

    Both streams of a batch go through one stacked forward. With
    TPU.EVAL_DEVICE_SPLIT the batch crosses to the device unsplit and the
    forward splits it there; otherwise the prefetch thread splits and stacks
    it on the host. Either way the copy runs ahead on the prefetch thread,
    and the results of a batch are read back only once PIPELINE_DEPTH later
    batches are queued behind it, so the host's decoding of one batch
    overlaps the device's work on the next ones. The rows' original sizes
    cross with their batch, so the host waits for the card only to drain.

    On a mesh each data rank evaluates its loader's shard (the loader pads
    every shard to the same batch count, so the ranks run the same number
    of forwards); under sequence parallelism the stacked batch keeps this
    rank's frames (``mesh.local_batch``). The ranks of one model or seq
    group compute the same predictions, so only the first of each
    contributes to the evaluator's gather.

    Spans (``core/trace.py``, when the recorder is on), per batch:
    ``eval.next_batch`` (the wait on the prefetch stream), ``eval.forward``
    (the forward's host enqueue), ``eval.postprocess``, and for each batch
    drained ``eval.drain`` holding ``eval.readback`` (``to_host``) and
    ``eval.merge`` (the stream merge and the evaluator's update); the
    prefetch thread records ``prefetch.place``."""
    fwd = make_eval_forward(cfg, model)
    device_split = eval_device_split_active(cfg)
    device = next(model.parameters()).device
    mesh = getattr(model, "mesh", None)

    def host_side(item):
        batch, _targets, meta = item
        batch, sizes, m1, m2 = eval_inputs(batch, meta, device_split)
        return local_batch(batch, mesh), sizes, m1, m2

    def drain(item):
        res, fv, m1, m2 = item
        with trace.span("eval.drain"):
            with trace.span("eval.readback"):
                boxes, s_idx, e_idx, fv = to_host((*res, fv))
            with trace.span("eval.merge"):
                bbox_pred, temp_pred = merge_two_streams(boxes, s_idx, e_idx, fv, m1, m2)
                evaluator.update(bbox_pred)
                evaluator.video_update(temp_pred)

    stream = prefetch_to_device((host_side(x) for x in loader), device, depth=2)
    pending: deque = deque()
    try:
        while True:
            with trace.span("eval.next_batch"):
                item = next(stream, None)
            if item is None:
                break
            batch, sizes, m1, m2 = item
            with trace.span("eval.forward"):
                out = fwd(batch)
                fv = out["frame_valid"]
            with trace.span("eval.postprocess"), torch.inference_mode():
                res = postprocess(out["pred_boxes"], out["pred_sted"], sizes, fv)
            pending.append((res, fv, m1, m2))
            if len(pending) > PIPELINE_DEPTH:
                drain(pending.popleft())
        while pending:
            drain(pending.popleft())
    finally:
        stream.close()
    synchronize()
    evaluator.synchronize_between_processes(contribute=mesh is None or mesh.is_group_leader)
    if logger is not None and is_main_process():
        logger.info("Inference complete; computing metrics")
    return evaluator.summarize()
