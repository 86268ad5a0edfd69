"""Temporal clip sampling: train-time crop + frame-count / fps downsampling.

Reference: datasets/data_utils.py:81-222 (make_vidstg_input_clip /
make_hcstvg_input_clip). Pure numpy over the precomputed per-item arrays;
randomness through an explicit Generator.

Item schema (built by annotations.py):
    frame_ids : list[int] absolute frame ids of the usable segment
    actioness : float[T0] 1 inside the GT temporal span
    start_heatmap / end_heatmap : float[T0] boundary pseudo-heatmaps
    bboxs     : float[N, 4] xyxy, one per GT-span frame
    gt_temp_bound, segment_bound, width, height, description, ...
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _temporal_crop_indices(actioness: np.ndarray, rng: np.random.Generator):
    """Random crop keeping the GT span: start from before-span, end from after.

    ref data_utils.py:188-203.
    """
    span = np.flatnonzero(actioness)
    n = len(actioness)
    starts = np.arange(0, span[0])
    ends = np.arange(span[-1] + 1, n)
    start_idx = int(rng.choice(starts)) if len(starts) else 0
    end_idx = int(rng.choice(ends)) if len(ends) else n - 1
    return start_idx, end_idx


def _slice_item(video_data: Dict, keep: List[int]) -> Dict:
    out = dict(video_data)
    out["frame_ids"] = [video_data["frame_ids"][i] for i in keep]
    for key in ("actioness", "start_heatmap", "end_heatmap"):
        out[key] = np.asarray(video_data[key])[keep]
    return out


def make_vidstg_input_clip(cfg, split: str, video_data: Dict, rng: np.random.Generator) -> Dict:
    """Optional temporal crop + uniform linspace downsample to N frames.

    ref data_utils.py:158-222 (train N = TRAIN_SAMPLE_NUM, test N = 2x).
    """
    n_target = cfg.INPUT.TRAIN_SAMPLE_NUM
    if split != "train":
        n_target *= 2

    actioness = np.asarray(video_data["actioness"])
    n0 = len(actioness)
    crop = split == "train" and rng.random() < cfg.INPUT.TEMP_CROP_PROB
    if crop:
        s, e = _temporal_crop_indices(actioness, rng)
        keep = list(range(s, e + 1))
    else:
        keep = list(range(n0))

    if len(keep) > n_target:
        idx = np.linspace(0, len(keep) - 1, num=n_target)
        keep = [keep[int(i)] for i in idx]
    return _slice_item(video_data, keep)


def make_hcstvg_input_clip(cfg, split: str, video_data: Dict, rng: np.random.Generator) -> Dict:
    """fps-based resampling (videos are 20 s) + optional crop.

    ref data_utils.py:81-155 (test fps = 2x SAMPLE_FPS).
    """
    input_fps = cfg.INPUT.SAMPLE_FPS * (2 if split == "test" else 1)
    crop = split == "train" and rng.random() >= 1 - cfg.INPUT.TEMP_CROP_PROB

    frame_ids = video_data["frame_ids"]
    frame_count = video_data["frame_count"]
    video_fps = frame_count / 20.0
    rate = input_fps / video_fps

    keep = [0]
    for idx in range(len(frame_ids)):
        if int(frame_ids[keep[-1]] * rate) < int(frame_ids[idx] * rate):
            keep.append(idx)
    if keep[-1] != len(frame_ids) - 1:
        keep.append(len(frame_ids) - 1)
    item = _slice_item(video_data, keep)

    if crop:
        s, e = _temporal_crop_indices(np.asarray(item["actioness"]), rng)
        item = _slice_item(item, list(range(s, e + 1)))
    return item


def gt_box_alignment(item: Dict) -> np.ndarray:
    """Per-sampled-frame GT boxes for the frames inside the span.

    ref datasets/vidstg.py:167-173: box index = frame_id - gt_temp_bound[0].
    Returns float [n_span_frames, 4] xyxy.
    """
    frame_ids = item["frame_ids"]
    temp_gt = item["gt_temp_bound"]
    action_idx = np.flatnonzero(item["actioness"])
    sel = [frame_ids[i] - temp_gt[0] for i in range(action_idx[0], action_idx[-1] + 1)]
    return np.asarray(item["bboxs"], np.float32)[sel].reshape(-1, 4)
