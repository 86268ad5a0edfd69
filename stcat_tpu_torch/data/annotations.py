"""Annotation preprocessing: raw VidSTG / HC-STVG json -> the data cache.

The JAX package's data/annotations.py, kept byte-compatible: the same raw
annotations and seed write the same cache files, one gzipped json per split
and kind:

    <DATA_DIR>/data_cache/<dataset>-<split>-input.json.gz   (model input items)
    <DATA_DIR>/data_cache/<dataset>-<split>-anno.json.gz    (evaluator GT)

Item schema matches the reference's (frame_ids, actioness, heatmaps, bboxs,
gt_temp_bound, ...) so the clip samplers and evaluators carry identical
semantics. Sentence cleanup applies the published typo-correction table
(datasets/words.py, shipped as assets/vidstg_typos.json).
"""

from __future__ import annotations

import gzip
import json
import os
import re
from copy import deepcopy
from typing import Dict, Tuple

import numpy as np

SENTENCE_SPLIT_REGEX = re.compile(r"(\W+)")
EPSILON = 1e-10

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")


def load_typo_dict() -> Dict[str, str]:
    with open(os.path.join(_ASSET_DIR, "vidstg_typos.json")) as f:
        return json.load(f)


def clean_sentence(sentence: str, typos: Dict[str, str]) -> str:
    """Lowercase, strip non-word tokens, fix known misspellings.

    ref datasets/vidstg.py:42-64.
    """
    word_pt = re.compile(r"[A-Za-z]", re.S)
    words = SENTENCE_SPLIT_REGEX.split(sentence.strip())
    words = [w.lower() for w in words if len(w) > 0 and w != " "]
    words = [w for w in words if word_pt.findall(w)]
    words = [typos.get(w, w) for w in words]
    return " ".join(words)


def _boundary_heatmaps(actioness: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Start/end pseudo-heatmaps. ref vidstg.py:252-270 (produced for parity;
    the criterion derives its gaussian targets directly)."""
    span = np.flatnonzero(actioness)
    start_idx, end_idx = span[0], span[-1]
    n = len(actioness)
    pseudo = (1 - (n - 3) * EPSILON - 0.5) / 2

    def heat(idx):
        h = np.full(n, EPSILON)
        h[idx] = 0.5
        if idx > 0:
            h[idx - 1] = pseudo
        if idx < n - 1:
            h[idx + 1] = pseudo
        return h

    return heat(start_idx), heat(end_idx)


# --------------------------------------------------------------------------
# VidSTG
# --------------------------------------------------------------------------

def merge_vidstg_pairs(data_dir: str, split: str) -> Dict:
    """Merge temporal GT (sent_annos) with per-video box trajectories
    (bbox_annos) into per-(video, sentence) pairs. ref vidstg.py:319-412."""
    out_dir = os.path.join(data_dir, "vstg_annos")
    out_path = os.path.join(out_dir, f"{split}.json")
    if os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)
    os.makedirs(out_dir, exist_ok=True)

    with open(os.path.join(data_dir, "sent_annos", f"{split}_annotations.json")) as f:
        sent_annos = json.load(f)

    def get_bbox(bboxs, tid):
        for bb in bboxs:
            if bb["tid"] == tid:
                return bb
        return None

    merged, pair_cnt, spoiled = {}, 0, set()
    for anno in sent_annos:
        base = {
            "vid": anno["vid"],
            "fps": anno["fps"],
            "used_segment": anno["used_segment"],
            "width": anno["width"],
            "height": anno["height"],
            "ori_temp_gt": deepcopy(anno["temporal_gt"]),
            "frame_count": anno["used_segment"]["end_fid"]
            - anno["used_segment"]["begin_fid"] + 1,
        }
        with open(os.path.join(data_dir, "bbox_annos", anno["vid"] + ".json")) as f:
            bbox_annos = json.load(f)
        trajectories = bbox_annos["trajectories"]

        for sent_type in ("captions", "questions"):
            for sent in anno[sent_type]:
                pair = deepcopy(base)
                pair["id"] = pair_cnt
                pair["qtype"] = "declar" if sent_type == "captions" else "inter"
                pair["sentence"] = sent
                tid = sent["target_id"]
                pair["target_category"] = get_bbox(anno["subject/objects"], tid)["category"]
                pair["target_bboxs"] = []
                start = anno["temporal_gt"]["begin_fid"]
                end = min(anno["temporal_gt"]["end_fid"] + 1, anno["frame_count"])
                for idx in range(start, end):
                    bb = get_bbox(trajectories[idx], tid)
                    if bb is None:
                        if idx != end - 1:
                            pair["target_bboxs"].append({})
                            spoiled.add(pair_cnt)
                        else:
                            pair["target_bboxs"].append(pair["target_bboxs"][-1].copy())
                    else:
                        pair["target_bboxs"].append(bb["bbox"])
                merged[pair_cnt] = pair
                pair_cnt += 1

    with open(out_path, "w") as f:
        json.dump(merged, f)
    return merged


def build_vidstg_cache(data_dir: str, split: str, rng: np.random.Generator):
    """Build (input items, eval annos). ref vidstg.py:203-317."""
    merged = merge_vidstg_pairs(data_dir, split)
    items, annos = [], []
    for key in merged:
        gt = merged[key]
        # spoiled pairs: GT outside used segment, box-count mismatch, or
        # holes in the trajectory (ref vidstg.py:226-232)
        seg = gt["used_segment"]
        if (
            gt["ori_temp_gt"]["end_fid"] < seg["begin_fid"]
            or gt["ori_temp_gt"]["begin_fid"] > seg["end_fid"]
        ):
            continue
        start_fid, end_fid = seg["begin_fid"], seg["end_fid"]
        tg_begin = gt["ori_temp_gt"]["begin_fid"]
        tg_end = min(gt["ori_temp_gt"]["end_fid"], end_fid)
        if len(gt["target_bboxs"]) != tg_end - tg_begin + 1:
            continue
        if any(len(bb) == 0 for bb in gt["target_bboxs"]):
            continue

        frame_ids = list(range(start_fid, end_fid + 1))
        actioness = np.asarray(
            [int(tg_begin <= fid <= tg_end) for fid in frame_ids], np.float32
        )
        start_hm, end_hm = _boundary_heatmaps(actioness)
        bbox_array = np.asarray(
            [
                [bb["xmin"], bb["ymin"], bb["xmax"], bb["ymax"]]
                for bb in gt["target_bboxs"]
            ],
            np.float32,
        )
        annos.append(
            {
                "item_id": gt["id"],
                "vid": gt["vid"],
                "bboxs": {
                    str(fid): bbox_array[fid - tg_begin].tolist()
                    for fid in range(tg_begin, tg_end + 1)
                },
                "description": gt["sentence"]["description"],
                "qtype": gt["qtype"],
                "gt_temp_bound": [tg_begin, tg_end],
                "segment_bound": [start_fid, end_fid],
            }
        )
        items.append(
            {
                "item_id": gt["id"],
                "vid": gt["vid"],
                "frame_ids": frame_ids,
                "width": gt["width"],
                "height": gt["height"],
                "start_heatmap": start_hm.tolist(),
                "end_heatmap": end_hm.tolist(),
                "actioness": actioness.tolist(),
                "bboxs": bbox_array.tolist(),
                "gt_temp_bound": [tg_begin, tg_end],
                "segment_bound": [start_fid, end_fid],
                "qtype": gt["qtype"],
                "description": gt["sentence"]["description"],
                "object": gt["target_category"],
            }
        )
    order = rng.permutation(len(items))
    items = [items[i] for i in order]
    return items, annos


# --------------------------------------------------------------------------
# HC-STVG v1
# --------------------------------------------------------------------------

HCSTVG_MISSING = ("10__Gvp-cj3bmIY.mp4", "1_aMYcLyh9OhU.mkv")


def build_hcstvg_cache(data_dir: str, split: str, rng: np.random.Generator):
    """ref hcstvg.py:142-276. Boxes arrive xywh -> converted to xyxy."""
    anno_path = os.path.join(data_dir, "annos", "hcstvg_v1", f"{split}.json")
    with open(anno_path) as f:
        raw = json.load(f)

    items, annos = [], []
    pair_cnt = 0
    for vid in raw:
        a = raw[vid]
        frame_count = a["img_num"]
        tube_start = max(0, a["st_frame"] - 1)
        tube_end = min(tube_start + len(a["bbox"]) - 1, frame_count - 1)
        frame_ids = list(range(0, frame_count - 1))
        actioness = np.asarray(
            [int(tube_start <= fid <= tube_end) for fid in frame_ids], np.float32
        )
        start_hm, end_hm = _boundary_heatmaps(actioness)
        bbox_array = np.asarray(
            [[x, y, x + w, y + h] for (x, y, w, h) in a["bbox"]], np.float32
        )
        annos.append(
            {
                "item_id": pair_cnt,
                "vid": vid,
                "bboxs": {
                    str(fid): bbox_array[fid - tube_start].tolist()
                    for fid in range(tube_start, tube_end + 1)
                },
                "description": a["caption"],
                "gt_temp_bound": [tube_start, tube_end],
                "frame_count": frame_count,
            }
        )
        items.append(
            {
                "item_id": pair_cnt,
                "vid": vid,
                "frame_ids": frame_ids,
                "width": a["width"],
                "height": a["height"],
                "start_heatmap": start_hm.tolist(),
                "end_heatmap": end_hm.tolist(),
                "actioness": actioness.tolist(),
                "bboxs": bbox_array.tolist(),
                "gt_temp_bound": [tube_start, tube_end],
                "description": a["caption"],
                "object": "person",
                "frame_count": frame_count,
            }
        )
        pair_cnt += 1

    items = [it for it in items if it["vid"] not in HCSTVG_MISSING]
    order = rng.permutation(len(items))
    items = [items[i] for i in order]
    return items, annos


# --------------------------------------------------------------------------
# cache IO
# --------------------------------------------------------------------------

def cache_paths(data_dir: str, dataset: str, split: str) -> Tuple[str, str]:
    cache_dir = os.path.join(data_dir, "data_cache")
    tag = "vidstg" if dataset == "VidSTG" else "hcstvg"
    return (
        os.path.join(cache_dir, f"{tag}-{split}-input.json.gz"),
        os.path.join(cache_dir, f"{tag}-{split}-anno.json.gz"),
    )


def _dump(obj, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump(obj, f)


def _load(path):
    with gzip.open(path, "rt") as f:
        return json.load(f)


def load_or_build_cache(data_dir: str, dataset: str, split: str, seed: int = 0):
    """Returns (items, annos), building + persisting the cache on first use.

    ref: the rank-0 cache warm at scripts/train_net.py:58-65.
    """
    input_path, anno_path = cache_paths(data_dir, dataset, split)
    if os.path.exists(input_path) and os.path.exists(anno_path):
        return _load(input_path), _load(anno_path)
    rng = np.random.default_rng(seed)
    if dataset == "VidSTG":
        items, annos = build_vidstg_cache(data_dir, split, rng)
    elif dataset == "HC-STVG":
        items, annos = build_hcstvg_cache(data_dir, split, rng)
    else:
        raise ValueError(f"unknown dataset {dataset}")
    # sentence cleanup is applied to the *input* items only (ref vidstg.py:83)
    typos = load_typo_dict() if dataset == "VidSTG" else {}
    for it in items:
        it["description"] = clean_sentence(it["description"], typos)
    _dump(items, input_path)
    _dump(annos, anno_path)
    return items, annos
