"""vIoU evaluators for VidSTG and HC-STVG (host-side numpy).

Reference: datasets/evaluation/vidstg_eval.py + hcstvg_eval.py (the two files
are near-identical; the only real difference is per-qtype aggregation for
VidSTG). Metric semantics are preserved operation-for-operation:

  tIoU  : temporal intersection / union of [start, end) frame spans
  vIoU  : sum of per-frame box IoU over GT-annotated frames that fall in the
          predicted-cap-GT temporal intersection, / |union span|
  gt_vIoU: mean box IoU over all GT-annotated frames
  vIoU@R / gt_vIoU@R at thresholds (0.3, 0.5)

The JAX package's eval/evaluator.py; predictions of several processes are
merged through core/dist.py's object gather.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.dist import all_gather_objects, is_main_process
from ..data.annotations import load_or_build_cache


def np_box_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """N x M IoU matrix of xyxy boxes, in float64 (ref utils/box_utils.py:10-60)."""
    boxes1 = np.asarray(boxes1, dtype=np.float64)
    boxes2 = np.asarray(boxes2, dtype=np.float64)
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = np.maximum(boxes1[:, None, :2], boxes2[:, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[:, 2:])
    wh = (rb - lt).clip(min=0)
    inter = wh[:, :, 0] * wh[:, :, 1]
    union = area1[:, None] + area2 - inter
    return inter / union


class GroundingEvaluator:
    """Accumulates per-frame box predictions + per-video sted predictions."""

    def __init__(
        self,
        data_dir: str,
        dataset: str,             # "VidSTG" | "HC-STVG"
        subset: str = "test",
        iou_thresholds=(0.3, 0.5),
        save_pred: bool = False,
        save_dir: Optional[str] = None,
        logger=None,
    ):
        self.dataset = dataset
        self.per_qtype = dataset == "VidSTG"
        self.iou_thresholds = tuple(iou_thresholds)
        self.save_pred = save_pred
        self.save_dir = save_dir
        self.logger = logger

        _, annos = load_or_build_cache(data_dir, dataset, subset)
        self.vid2steds, self.vid2box, self.vid2names, self.vid2sents = {}, {}, {}, {}
        for a in annos:
            vid = a["item_id"]
            self.vid2names[vid] = a["vid"]
            self.vid2sents[vid] = a["description"]
            self.vid2box[vid] = {int(k): [v] for k, v in a["bboxs"].items()}
            self.vid2steds[vid] = a["gt_temp_bound"]

        self.predictions: Dict = {}
        self.video_predictions: Dict = {}
        self.results = None

    # ------------------------------------------------------------------
    def update(self, predictions: Dict) -> None:
        """predictions: {item_id: {frame_id: [[x0,y0,x1,y1]]}}"""
        self.predictions.update(predictions)

    def video_update(self, video_predictions: Dict) -> None:
        """video_predictions: {item_id: {"sted": [s, e], "qtype": ...}}"""
        self.video_predictions.update(video_predictions)

    def synchronize_between_processes(self) -> None:
        """Merge predictions across processes (a no-op in one process)."""
        for merged, ours in (
            (all_gather_objects(self.predictions), "predictions"),
            (all_gather_objects(self.video_predictions), "video_predictions"),
        ):
            combined = {}
            for d in merged:
                combined.update(d)
            setattr(self, ours, combined)

    # ------------------------------------------------------------------
    def evaluate_one(self, video_id, video_pred) -> Dict:
        gt_sted = self.vid2steds[video_id]
        pred_sted = video_pred["sted"]
        max_start = max(gt_sted[0], pred_sted[0])
        min_end = min(gt_sted[1], pred_sted[1])
        min_start = min(gt_sted[0], pred_sted[0])
        max_end = max(gt_sted[1], pred_sted[1])
        if min_end <= max_start:
            tiou = 0.0
        else:
            inter = min_end - max_start
            union = (gt_sted[1] - gt_sted[0]) + (pred_sted[1] - pred_sted[0]) - inter
            tiou = inter / union

        union_predgt = set(range(min_start, max_end))
        inter_predgt = set(range(max_start, min_end))

        viou, gt_viou = 0.0, 0.0
        prediction = self.predictions[video_id]
        for fid, gt_boxes in self.vid2box[video_id].items():
            if fid not in prediction:
                raise RuntimeError(f"No prediction for frame {fid} of video {video_id}")
            iou = np_box_iou(np.asarray(prediction[fid]), np.asarray(gt_boxes))[0][0]
            if fid in inter_predgt:
                viou += iou
            gt_viou += iou

        viou /= max(len(union_predgt), 1)
        gt_viou /= max(len(self.vid2box[video_id]), 1)
        m = {
            "gt_sted": gt_sted,
            "pred_sted": pred_sted,
            "tiou": tiou,
            "viou": viou,
            "gt_viou": gt_viou,
            "qtype": video_pred.get("qtype", "none"),
        }
        for th in self.iou_thresholds:
            m[f"viou@{th}"] = float(viou > th)
            m[f"gt_viou@{th}"] = float(gt_viou > th)
        return m

    def summarize(self) -> Optional[Dict]:
        if not is_main_process():
            return None
        self.results = {
            vid: self.evaluate_one(vid, pred)
            for vid, pred in self.video_predictions.items()
        }
        keys = ["tiou", "viou", "gt_viou"] + [
            f"{p}@{th}" for p in ("viou", "gt_viou") for th in self.iou_thresholds
        ]
        out = {}
        if self.per_qtype:
            categories = sorted(set(x["qtype"] for x in self.results.values()))
            for cat in categories:
                rows = [x for x in self.results.values() if x["qtype"] == cat]
                for k in keys:
                    out[f"{cat}_{k}"] = float(np.mean([r[k] for r in rows]))
        else:
            for k in keys:
                out[k] = float(np.mean([r[k] for r in self.results.values()]))

        if self.logger is not None:
            lines = "\n".join(f"{k}: {v:.4f}" for k, v in out.items())
            self.logger.info("\n" + "=" * 80 + f"\n{lines}\n" + "=" * 80)
        if self.save_pred and self.save_dir:
            import json
            import os

            payload = {
                **out,
                "predictions": {str(k): v for k, v in self.predictions.items()},
                "video_predictions": {
                    str(k): v for k, v in self.video_predictions.items()
                },
            }
            with open(os.path.join(self.save_dir, "test_results.json"), "w") as f:
                json.dump(payload, f)
        return out


def build_evaluator(cfg, logger=None, mode: str = "test") -> GroundingEvaluator:
    """ref datasets/evaluation/__init__.py:4-24."""
    return GroundingEvaluator(
        data_dir=cfg.DATA_DIR,
        dataset=cfg.DATASET.NAME,
        subset=mode,
        iou_thresholds=(0.3, 0.5),
        save_pred=(mode == "test"),
        save_dir=cfg.OUTPUT_DIR or None,
        logger=logger,
    )
