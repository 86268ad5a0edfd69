"""Host-side eval transform plan (numpy): shortest-side resize with a max cap,
composed into the affine map the on-device resampler executes."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


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


@dataclass
class TransformPlan:
    """Pixel work, not yet done: ``ops`` is ("resize", oh, ow) steps on the
    (post-flip) source; ``affine`` = (ay, by, ax, bx) maps output coords to
    source coords, y_src = ay * y_out + by (x likewise)."""

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


class VideoTransform:
    """Eval transform: one resize of the shortest side to RESOLUTION (max 720)."""

    def __init__(self, resolution: int, max_size: int = 720):
        self.resolution = resolution
        self.max_size = max_size

    def plan(self, src_hw: Tuple[int, int], boxes: np.ndarray, text: str):
        """Returns (plan, boxes_xyxy_out, text)."""
        h, w = src_hw
        oh, ow = resize_keep_ratio(self.resolution, (h, w), self.max_size)
        boxes = boxes * np.asarray([ow / w, oh / h, ow / w, oh / h], np.float32)
        ops = [("resize", oh, ow)] if (oh, ow) != (h, w) else []
        affine, out_hw = _compose_affine(ops, (h, w))
        return TransformPlan(src_hw=(h, w), flip=False, ops=ops, out_hw=out_hw,
                             affine=affine), boxes, text


def build_transforms(cfg) -> VideoTransform:
    """The eval transform for a config (the train augmentation is not ported)."""
    return VideoTransform(resolution=cfg.INPUT.RESOLUTION)
