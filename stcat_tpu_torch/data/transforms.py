"""Host-side transform plans (numpy), composed into the affine map the
on-device resampler executes (``ops/preprocess.py``).

Eval: one resize of the shortest side to RESOLUTION (max 720). Train: hflip
(with the left/right word swap in the sentence), then RandomSelect of a
multi-scale resize or resize -> RandomSizeCrop -> resize. The box math is
done here on the host; every random draw comes from the caller's
``np.random.Generator``, in the JAX package's order, so a seed gives the
same plan, boxes and text there and here. Pixels are resampled on the card
along the plan's composed affine (``ops/preprocess.py``), or, with
``TPU.DEVICE_PREPROCESS false``, here on the host: ``apply_pixels`` replays
the plan's op chain (flip, chained bilinear resizes, crops) on float32
frames and ``VideoTransform.__call__`` normalises them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def bilinear_resize(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Separable bilinear resize of [T, H, W, C] with half-pixel centers
    (``F.interpolate(..., align_corners=False)`` without antialiasing), edge
    taps clamped."""
    t, h, w, c = frames.shape
    if (h, w) == (out_h, out_w):
        return frames

    def axis_weights(n_in, n_out):
        src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        lo = np.floor(src).astype(np.int64)
        frac = (src - lo).astype(np.float32)
        return np.clip(lo, 0, n_in - 1), np.clip(lo + 1, 0, n_in - 1), frac

    y0, y1, fy = axis_weights(h, out_h)
    x0, x1, fx = axis_weights(w, out_w)
    top, bot = frames[:, y0], frames[:, y1]
    fr = top + (bot - top) * fy[None, :, None, None]
    left, right = fr[:, :, x0], fr[:, :, x1]
    return left + (right - left) * fx[None, None, :, None]


def resize_keep_ratio(size: int, image_hw: Tuple[int, int],
                      max_size: Optional[int]) -> Tuple[int, int]:
    """Target (h, w) for a shortest-side resize to ``size`` capped at ``max_size``."""
    h, w = image_hw
    if max_size is not None:
        min_orig, max_orig = float(min(h, w)), float(max(h, w))
        if max_orig / min_orig * size > max_size:
            size = int(round(max_size * min_orig / max_orig))
    if (w <= h and w == size) or (h <= w and h == size):
        return (h, w)
    if w < h:
        return (int(size * h / w), size)
    return (size, int(size * w / h))


def boxes_resize(boxes: np.ndarray, ratios: Tuple[float, float]) -> np.ndarray:
    rw, rh = ratios
    return boxes * np.asarray([rw, rh, rw, rh], np.float32)


def boxes_hflip(boxes: np.ndarray, width: float) -> np.ndarray:
    x0, y0, x1, y1 = boxes.T
    return np.stack([width - x1, y0, width - x0, y1], axis=1)


def boxes_crop(boxes: np.ndarray, region: Tuple[int, int, int, int]) -> np.ndarray:
    """region = (top, left, h, w)."""
    top, left, h, w = region
    x0 = np.clip(boxes[:, 0] - left, 0, w)
    y0 = np.clip(boxes[:, 1] - top, 0, h)
    x1 = np.clip(boxes[:, 2] - left, 0, w)
    y1 = np.clip(boxes[:, 3] - top, 0, h)
    return np.stack([x0, y0, x1, y1], axis=1)


def crop_valid(boxes: np.ndarray, region) -> bool:
    c = boxes_crop(boxes, region)
    return bool(np.all((c[:, 0] < c[:, 2]) & (c[:, 1] < c[:, 3])))


def boxes_to_normalized_cxcywh(boxes: np.ndarray, image_hw: Tuple[int, int]) -> np.ndarray:
    h, w = image_hw
    x0, y0, x1, y1 = boxes.T
    x0, x1 = x0 / w, x1 / w
    y0, y1 = y0 / h, y1 / h
    return np.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], axis=1).astype(np.float32)


def swap_left_right(text: str) -> str:
    """A flipped clip's sentence: 'left' and 'right' swapped."""
    return (text.replace("right", "*&^special^&*").replace("left", "right")
            .replace("*&^special^&*", "left"))


@dataclass
class TransformPlan:
    """Pixel work, not yet done: ``ops`` is ("resize", oh, ow) and ("crop",
    top, left, h, w) steps on the (post-flip) source; ``affine`` = (ay, by,
    ax, bx) maps output coords to source coords, y_src = ay * y_out + by (x
    likewise)."""

    src_hw: Tuple[int, int]
    flip: bool
    ops: List[tuple]
    out_hw: Tuple[int, int]
    affine: Tuple[float, float, float, float]


def _compose_affine(ops: List[tuple], src_hw: Tuple[int, int]):
    """Fold the op chain into y_src = ay*y + by, x_src = ax*x + bx."""
    ay, by, ax, bx = 1.0, 0.0, 1.0, 0.0
    cur = src_hw
    for op in ops:
        if op[0] == "resize":
            oh, ow = op[1], op[2]
            ry, rx = cur[0] / oh, cur[1] / ow
            # x_old = (x_new + 0.5) * r - 0.5  (half-pixel centers)
            by, bx = ay * (0.5 * ry - 0.5) + by, ax * (0.5 * rx - 0.5) + bx
            ay, ax = ay * ry, ax * rx
            cur = (oh, ow)
        elif op[0] == "crop":
            top, left, ch, cw = op[1], op[2], op[3], op[4]
            by, bx = by + ay * top, bx + ax * left
            cur = (ch, cw)
        else:
            raise ValueError(op[0])
    return (ay, by, ax, bx), cur


def apply_pixels(frames: np.ndarray, plan: TransformPlan) -> np.ndarray:
    """The plan's op chain replayed on host frames [T, H, W, C] (float32 or
    uint8; a resize makes them float32): flip, then each resize and crop in
    turn. The card resamples once along ``plan.affine`` instead: the same
    pixels for one resize, within a smoothing difference for the train
    branch's resize -> crop -> resize."""
    if plan.flip:
        frames = frames[:, :, ::-1]
    for op in plan.ops:
        if op[0] == "resize":
            frames = bilinear_resize(np.asarray(frames, np.float32), op[1], op[2])
        else:
            top, left, ch, cw = op[1], op[2], op[3], op[4]
            frames = frames[:, top: top + ch, left: left + cw]
    return np.ascontiguousarray(frames)


class VideoTransform:
    """The train or eval transform plan of a clip; called on a sample, it
    also does the plan's pixel work on the host."""

    def __init__(self, resolution: int, is_train: bool = False, aug_scale: bool = True,
                 flip_prob: float = 0.5, max_size: int = 720, mean: np.ndarray = IMAGENET_MEAN,
                 std: np.ndarray = IMAGENET_STD, aug_crop: bool = True):
        self.resolution = resolution
        self.is_train = is_train
        self.flip_prob = flip_prob
        self.max_size = max_size
        self.mean = mean
        self.std = std
        self.aug_crop = aug_crop
        self.scales = ([resolution - 32 * i for i in range(4) if resolution - 32 * i > 0]
                       if aug_scale else [resolution])

    def _sample_crop(self, hw, boxes, rng, min_size=384, max_size=600, max_try=50):
        """RandomSizeCrop region that keeps every box non-empty; None = no
        crop this draw."""
        h, w = hw
        for _ in range(max_try):
            tw = int(rng.integers(min_size, min(w, max_size) + 1))
            th = int(rng.integers(min_size, min(h, max_size) + 1))
            if th >= h and tw >= w:
                return None
            top = int(rng.integers(0, max(h - th, 0) + 1))
            left = int(rng.integers(0, max(w - tw, 0) + 1))
            region = (top, left, min(th, h), min(tw, w))
            if crop_valid(boxes, region):
                return region
        return None

    def plan(self, src_hw: Tuple[int, int], boxes: np.ndarray, text: str,
             rng: Optional[np.random.Generator] = None):
        """Returns (plan, boxes_xyxy_out, text). A train transform draws from
        ``rng``, which it then requires."""
        if self.is_train and rng is None:
            raise ValueError("the train transform needs an np.random.Generator")
        h, w = src_hw
        flip = False
        if self.is_train and rng.random() < self.flip_prob:
            flip = True
            boxes = boxes_hflip(boxes, w)
            text = swap_left_right(text)
        ops: List[tuple] = []
        cur = (h, w)

        def add_resize(size: int, max_size: Optional[int]):
            nonlocal cur, boxes
            oh, ow = resize_keep_ratio(size, cur, max_size)
            boxes = boxes_resize(boxes, (ow / cur[1], oh / cur[0]))
            if (oh, ow) != cur:
                ops.append(("resize", oh, ow))
                cur = (oh, ow)

        if not self.is_train:
            add_resize(self.resolution, self.max_size)
        elif (not self.aug_crop) or rng.random() < 0.5:
            add_resize(int(rng.choice(self.scales)), self.max_size)
        else:
            add_resize(int(rng.choice([400, 500, 600])), None)
            region = self._sample_crop(cur, boxes, rng)
            if region is not None:
                top, left, ch, cw = region
                boxes = boxes_crop(boxes, region)
                ops.append(("crop", top, left, ch, cw))
                cur = (ch, cw)
            add_resize(int(rng.choice(self.scales)), self.max_size)

        affine, out_hw = _compose_affine(ops, (h, w))
        return TransformPlan(src_hw=(h, w), flip=flip, ops=ops, out_hw=out_hw,
                             affine=affine), boxes, text

    def __call__(self, sample: Dict, rng: Optional[np.random.Generator] = None) -> Dict:
        """The host pixel path of a sample with float32 ``frames`` [T, H, W,
        3] in [0, 1], ``boxes`` (xyxy pixels) and ``text``: plan, replay the
        plan on the frames, normalise them, and set ``boxes``, ``text`` and
        ``boxes_cxcywh`` (normalised to the output size). Returns the
        sample, updated in place."""
        plan, boxes, text = self.plan(sample["frames"].shape[1:3], sample["boxes"],
                                      sample["text"], rng)
        frames = apply_pixels(sample["frames"], plan)
        sample["frames"] = (np.asarray(frames, np.float32) - self.mean) / self.std
        sample["boxes"] = boxes
        sample["text"] = text
        sample["boxes_cxcywh"] = boxes_to_normalized_cxcywh(boxes, plan.out_hw)
        return sample


def build_transforms(cfg, is_train: bool = False) -> VideoTransform:
    return VideoTransform(resolution=cfg.INPUT.RESOLUTION, is_train=is_train,
                          aug_scale=cfg.INPUT.AUG_SCALE, flip_prob=cfg.INPUT.FLIP_PROB_TRAIN,
                          mean=np.asarray(cfg.INPUT.PIXEL_MEAN, np.float32),
                          std=np.asarray(cfg.INPUT.PIXEL_STD, np.float32),
                          aug_crop=cfg.INPUT.AUG_CROP)
