"""The reference's vIoU evaluation: per clip the temporal IoU of the
predicted and true spans, the vIoU (box IoU summed over true frames inside
both spans, over the spans' union) and the gt_vIoU (box IoU averaged over
the true frames), with their rates above 0.3 and 0.5; averaged per question
type for VidSTG, over all clips for HC-STVG."""

from __future__ import annotations

from typing import Dict

import numpy as np


def iou(a, b) -> float:
    a, b = np.asarray(a, np.float64).reshape(4), np.asarray(b, np.float64).reshape(4)
    wh = np.clip(np.minimum(a[2:], b[2:]) - np.maximum(a[:2], b[:2]), 0, None)
    inter = wh[0] * wh[1]
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union


def one(anno: Dict, boxes: Dict[int, list], span, thresholds=(0.3, 0.5)) -> Dict[str, float]:
    g0, g1 = anno["gt_temp_bound"]
    p0, p1 = span
    inter = min(g1, p1) - max(g0, p0)
    tiou = 0.0 if inter <= 0 else inter / ((g1 - g0) + (p1 - p0) - inter)
    union_fids = set(range(min(g0, p0), max(g1, p1)))
    inter_fids = set(range(max(g0, p0), min(g1, p1)))
    viou = gt_viou = 0.0
    for fid, box in anno["bboxs"].items():
        v = iou(boxes[int(fid)], box)
        if int(fid) in inter_fids:
            viou += v
        gt_viou += v
    viou /= max(len(union_fids), 1)
    gt_viou /= max(len(anno["bboxs"]), 1)
    out = {"tiou": tiou, "viou": viou, "gt_viou": gt_viou}
    for th in thresholds:
        out[f"viou@{th}"] = float(viou > th)
        out[f"gt_viou@{th}"] = float(gt_viou > th)
    return out


def summarize(annos: Dict[int, Dict], predictions: Dict, video_predictions: Dict,
              per_qtype: bool) -> Dict[str, float]:
    rows = {vid: (one(annos[vid], {int(f): b[0] for f, b in predictions[vid].items()},
                      video_predictions[vid]["sted"]), video_predictions[vid].get("qtype"))
            for vid in video_predictions}
    keys = ["tiou", "viou", "gt_viou", "viou@0.3", "viou@0.5", "gt_viou@0.3", "gt_viou@0.5"]
    if not per_qtype:
        return {k: float(np.mean([r[k] for r, _ in rows.values()])) for k in keys}
    out = {}
    for cat in sorted({q for _, q in rows.values()}):
        sel = [r for r, q in rows.values() if q == cat]
        out.update({f"{cat}_{k}": float(np.mean([r[k] for r in sel])) for k in keys})
    return out
