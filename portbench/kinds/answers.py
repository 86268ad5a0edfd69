"""The reference's answer to a clip and a sentence, and the two numbers a
served or evaluated answer is held to.

An answer is the port's: a box per frame id in original pixels and a span
[start, end + 1) in frame ids. The reference splits the clip into its even
and odd frame streams as the port's evaluation does, runs them through its
own model, and returns its boxes and, per stream, the score of every
(start, end) pair. ``box_px`` is the largest |port - reference| of a box
coordinate over the answer's frames; ``span_gap`` how far below the
reference's best the served span's score lies (``infer.span_gap``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..reference import infer as rinfer


def streams_of(frame_ids: Sequence[int]) -> List[List[int]]:
    return [list(frame_ids[0::2]), list(frame_ids[1::2])]


@torch.no_grad()
def reference_answer(model, frames: np.ndarray, text: str, frame_ids: Sequence[int], bucket: int,
                     cfg_input: Dict, vocab: int, device) -> Dict:
    """{"boxes": {fid: xyxy}, "span": [s, e + 1], "scores": [two T x T
    arrays], "fids": [two lists]} of the reference model on one clip."""
    fids = streams_of(frame_ids)
    clip = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    streams = [(clip[0::2], text), (clip[1::2], text)]
    inputs = rinfer.model_inputs(streams, bucket, cfg_input["RESOLUTION"], cfg_input["PIXEL_MEAN"],
                                 cfg_input["PIXEL_STD"], cfg_input["MAX_QUERY_LEN"], vocab)
    out = model.eval()(*inputs)
    h, w = frames.shape[1:3]
    boxes = rinfer.boxes_pixels(out["pred_boxes"], (h, w)).cpu().numpy()
    scores = rinfer.span_scores(out["pred_sted"], inputs[1]).cpu().numpy()
    per_stream, spans = [], []
    for k, f in enumerate(fids):
        per_stream.append({fid: boxes[k, j] for j, fid in enumerate(f)})
        n = len(f)
        flat = int(np.argmax(scores[k, :n, :n]))
        spans.append((f[flat // n], f[flat % n]))
    return {"boxes": rinfer.merged_boxes(per_stream),
            "span": [min(s for s, _ in spans), max(e for _, e in spans) + 1],
            "scores": [scores[k] for k in range(len(fids))], "fids": fids}


def gaps(answer: Dict, ref: Dict) -> Tuple[float, float]:
    """(box_px, span_gap) of an answer against the reference's."""
    fids = sorted(ref["boxes"])
    if sorted(int(f) for f in answer["boxes"]) != fids:
        return float("inf"), float("inf")
    got = {int(k): np.asarray(v, np.float64).reshape(-1) for k, v in answer["boxes"].items()}
    box = max(float(np.abs(got[f] - np.asarray(ref["boxes"][f], np.float64)).max()) for f in fids)
    return box, rinfer.span_gap(ref["scores"], ref["fids"], answer["span"])
