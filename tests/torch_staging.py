"""The serving batch as the predictor built it before requests were
staged, and requests staged as ``MicroBatcher.submit`` stages them: the
reference of the staging tests on the CPU (``tests/test_torch_serve.py``)
and on the card (``tests/test_torch_cuda.py``). Torch and numpy only."""

from concurrent.futures import Future

import numpy as np

from stcat_tpu_torch import serve
from stcat_tpu_torch.core.batch import to_device
from stcat_tpu_torch.data.batching import build_raw_batch, pick_bucket


def built_before_staging(pred, requests, place: bool = True):
    """The batch and stream meta ``predict_batch`` placed before requests
    were staged: the lanes padded with replicas of request 0, each split
    into its even and odd stream samples (a one-frame clip's stream twice,
    the second as padding), ``build_raw_batch``, then (``place``)
    ``to_device``."""
    reqs = list(requests) + [requests[0]] * (pred.max_batch - len(requests))
    s0, s1 = [], []
    for i, (frames, text, fids) in enumerate(reqs):
        fids = list(range(len(frames))) if fids is None else list(fids)
        pad = i >= len(requests)

        def sample(f, ids, pad):
            plan, _, txt = pred.transform.plan(f.shape[1:3], np.zeros((0, 4), np.float32), text)
            return {"frames_u8": np.ascontiguousarray(f), "plan": plan, "text": txt,
                    "item_id": i, "frame_ids": list(ids), "ori_size": f.shape[1:3], "pad": pad}

        if len(frames) >= 2:
            s0.append(sample(frames[0::2], fids[0::2], pad))
            s1.append(sample(frames[1::2], fids[1::2], pad))
        else:
            s0.append(sample(frames, fids, pad))
            s1.append(sample(frames, fids, True))
    t_bucket = pick_bucket(max(len(s["frame_ids"]) for s in s0 + s1), pred.cfg.TPU.FRAME_BUCKETS)
    raw, _, meta = build_raw_batch(s0 + s1, t_bucket, pred.tokenizer, pred.cfg.INPUT.MAX_QUERY_LEN)
    return (to_device(raw, pred.device) if place else raw), meta[: len(s0)], meta[len(s0):]


def staged(pred, requests):
    """The requests as MicroBatcher.submit queues them, their staging done."""
    out = []
    for r in requests:
        req = serve.Request(*r)
        req.staged = Future()
        req.staged.set_result(pred.stage(req))
        out.append(req)
    return out
