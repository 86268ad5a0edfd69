"""Which clip a training iteration loads, which of its frames it samples,
and the clip's targets, worked out from the corpus annotations and the
recipe: the STCAT reference's temporal sampling (datasets/data_utils.py,
``make_vidstg_input_clip`` and ``make_hcstvg_input_clip``), the loader's
seed rules, and the box arithmetic of the spatial plan. Written apart from
the port; the run compares what the port's loader produced with it.

The spatial plan (flip, resize and crop) is the one draw taken from the
port's batch: ``boxes`` maps the annotation's boxes through it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def epoch_order(seed: int, epoch: int, n: int, shuffle: bool) -> np.ndarray:
    """The epoch's item order: a permutation drawn from seed + epoch."""
    return np.random.default_rng(seed + epoch).permutation(n) if shuffle else np.arange(n)


def item_indices(seed: int, iteration: int, n: int, per_rank: int, ranks: int, rank: int,
                 shuffle: bool) -> List[int]:
    """The items one data rank loads at an iteration: the epoch's order,
    cut into global batches of per_rank x ranks slots (wrapping around at
    the epoch's end), every ranks-th slot this rank's. All items have one
    orientation, so grouping by aspect ratio keeps the order."""
    per_epoch = -(-n // (per_rank * ranks))
    epoch, within = divmod(iteration, per_epoch)
    order = np.resize(epoch_order(seed, epoch, n, shuffle), per_epoch * per_rank * ranks)
    mine = order[rank::ranks]
    return [int(i) for i in mine[within * per_rank:(within + 1) * per_rank]]


def sample_rng(seed: int, iteration: int, index: int) -> np.random.Generator:
    """The generator of one sample: (seed, iteration, item index)."""
    return np.random.default_rng((seed * 1_000_003 + iteration) % (2 ** 31) + int(index))


def _crop(actioness: np.ndarray, rng) -> Tuple[int, int]:
    """A random temporal crop that keeps the ground-truth span: its start
    before the span, its end after it."""
    span = np.flatnonzero(actioness)
    starts, ends = np.arange(0, span[0]), np.arange(span[-1] + 1, len(actioness))
    start = int(rng.choice(starts)) if len(starts) else 0
    end = int(rng.choice(ends)) if len(ends) else len(actioness) - 1
    return start, end


def vidstg_keep(item: Dict, n_target: int, crop_prob: float, train: bool, rng) -> List[int]:
    """Positions in the item's segment that a VidSTG clip samples: an
    optional crop, then ``n_target`` frames spread by linspace (twice as
    many at test time)."""
    if not train:
        n_target *= 2
    act = np.asarray(item["actioness"])
    keep = list(range(len(act)))
    if train and rng.random() < crop_prob:
        s, e = _crop(act, rng)
        keep = list(range(s, e + 1))
    if len(keep) > n_target:
        keep = [keep[int(i)] for i in np.linspace(0, len(keep) - 1, num=n_target)]
    return keep


def hcstvg_keep(item: Dict, sample_fps: float, crop_prob: float, split: str, rng) -> List[int]:
    """Positions an HC-STVG clip samples: the 20 s video resampled to
    SAMPLE_FPS (twice that at test time), then an optional crop."""
    fps = sample_fps * (2 if split == "test" else 1)
    crop = split == "train" and rng.random() >= 1 - crop_prob
    fids = item["frame_ids"]
    rate = fps / (item["frame_count"] / 20.0)
    keep = [0]
    for k in range(len(fids)):
        if int(fids[keep[-1]] * rate) < int(fids[k] * rate):
            keep.append(k)
    if keep[-1] != len(fids) - 1:
        keep.append(len(fids) - 1)
    if crop:
        s, e = _crop(np.asarray(item["actioness"])[keep], rng)
        keep = keep[s:e + 1]
    return keep


def keep_of(item: Dict, dataset: str, split: str, cfg_input: Dict, rng) -> List[int]:
    if dataset == "VidSTG":
        return vidstg_keep(item, cfg_input["TRAIN_SAMPLE_NUM"], cfg_input["TEMP_CROP_PROB"],
                           split == "train", rng)
    if dataset == "HC-STVG":
        return hcstvg_keep(item, cfg_input["SAMPLE_FPS"], cfg_input["TEMP_CROP_PROB"], split, rng)
    raise ValueError(dataset)


def boxes(xyxy: np.ndarray, src_w: int, flip: bool, scale: Sequence[float],
          off: Sequence[float], canvas_w: int, out_hw: Sequence[int]) -> np.ndarray:
    """Annotation boxes (xyxy, source pixels) -> normalised cxcywh in the
    plan's output. ``scale`` (ay, ax) and ``off`` (by, bx) map output pixel
    centres to source ones, y_src = ay y_out + by; a flipped batch's bx
    counts from the right edge of a source canvas ``canvas_w`` wide."""
    b = np.asarray(xyxy, np.float64).reshape(-1, 4)
    if flip:
        b = np.stack([src_w - b[:, 2], b[:, 1], src_w - b[:, 0], b[:, 3]], 1)
    ay, ax = (float(v) for v in scale)
    by, bx = (float(v) for v in off)
    if flip:
        bx -= canvas_w - src_w
    # pixel edges: x_src = ax x_out + (bx - 0.5 ax + 0.5)
    cx, cy = bx - 0.5 * ax + 0.5, by - 0.5 * ay + 0.5
    oh, ow = float(out_hw[0]), float(out_hw[1])
    x0 = np.clip((b[:, 0] - cx) / ax, 0, ow) / ow
    x1 = np.clip((b[:, 2] - cx) / ax, 0, ow) / ow
    y0 = np.clip((b[:, 1] - cy) / ay, 0, oh) / oh
    y1 = np.clip((b[:, 3] - cy) / ay, 0, oh) / oh
    return np.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], 1)


def targets(item: Dict, keep: List[int], t_bucket: int, flip: bool, scale, off, canvas_w: int,
            out_hw) -> Dict[str, np.ndarray]:
    """The clip's targets from its annotation: frame ids, actioness (1 on
    the ground-truth span's frames), the span's first and last sampled
    frame, and a box on each span frame."""
    fids = [item["frame_ids"][k] for k in keep]
    g0, g1 = item["gt_temp_bound"]
    act = np.zeros(t_bucket, np.float32)
    valid = np.zeros(t_bucket, bool)
    box = np.zeros((t_bucket, 4), np.float64)
    inside = [k for k, f in enumerate(fids) if g0 <= f <= g1]
    act[inside] = 1.0
    span = (inside[0], inside[-1])
    valid[span[0]:span[1] + 1] = True
    src = [item["bboxs"][fids[k] - g0] for k in range(span[0], span[1] + 1)]
    box[span[0]:span[1] + 1] = boxes(np.asarray(src), item["width"], flip, scale, off, canvas_w,
                                     out_hw)
    return {"frame_ids": fids, "actioness": act, "box_valid": valid, "boxes": box,
            "temp_bound": np.asarray(span, np.int64)}
