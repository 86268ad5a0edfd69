"""Cache-backed VidSTG / HC-STVG datasets.

``__getitem__(index, rng)`` samples a clip, draws its transform plan and
returns a raw sample for ``data/batching.py::build_raw_batch``: uint8 frames
[T, h, w, 3] (decoded, untransformed), the TransformPlan, boxes_cxcywh of
the GT-span frames, actioness [T], the sentence and the clip's metadata.
Pixels are resampled and normalised on the card (``ops/preprocess.py``).
The host pixel path (``TPU.DEVICE_PREPROCESS false``) and the yuv420 ingest
are not ported (ROADMAP Queue A items 1-2).
"""

from __future__ import annotations

import os
from copy import deepcopy
from typing import Dict, Optional

import numpy as np

from .annotations import load_or_build_cache
from .decode import decode_frames, load_frame_images
from .sampling import gt_box_alignment, make_hcstvg_input_clip, make_vidstg_input_clip
from .transforms import VideoTransform, boxes_to_normalized_cxcywh, build_transforms


def check_raw_ingest(cfg) -> None:
    """The loader's input path: raw uint8 RGB pixels only."""
    if not cfg.TPU.DEVICE_PREPROCESS:
        raise NotImplementedError(
            "TPU.DEVICE_PREPROCESS false (the host pixel path) is not ported; "
            "see ROADMAP.md, Queue A")
    if cfg.TPU.INGEST_LAYOUT != "rgb":
        raise NotImplementedError(
            f"TPU.INGEST_LAYOUT {cfg.TPU.INGEST_LAYOUT!r} is not ported (rgb only); "
            "see ROADMAP.md, Queue A")


class GroundingDataset:
    """Common machinery of both benchmarks."""

    def __init__(self, cfg, split: str, transforms: Optional[VideoTransform] = None):
        self.cfg = cfg
        self.split = split
        self.transforms = transforms or build_transforms(cfg, split == "train")
        self.data_dir = cfg.DATA_DIR
        self.items, self.annos = load_or_build_cache(cfg.DATA_DIR, cfg.DATASET.NAME, split,
                                                     seed=cfg.SEED)
        if cfg.DATA_TRUNK is not None:
            self.items = self.items[: cfg.DATA_TRUNK]

    def __len__(self) -> int:
        return len(self.items)

    def sample_clip(self, item: Dict, rng) -> Dict:
        raise NotImplementedError

    def video_path(self, item: Dict) -> str:
        raise NotImplementedError

    def load_frames(self, item: Dict) -> np.ndarray:
        """uint8 [T, H, W, 3] of the sampled frame_ids: from the frame
        directory when the video has one, else decoded by ffmpeg."""
        frame_dir = os.path.join(self.data_dir, "frame")
        if os.path.isdir(os.path.join(frame_dir, str(item["vid"]))):
            return load_frame_images(frame_dir, str(item["vid"]), item["frame_ids"])
        return decode_frames(self.video_path(item), item["frame_ids"], item["height"],
                             item["width"])

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None,
                    plan_only: bool = False) -> Dict:
        """``plan_only``: zero-filled frames of the decode shape instead of
        decoded ones. The rng stream is the same (the plan draws before
        decode, and decode draws nothing), so the sample's shapes, plan and
        targets are those of the real one: ``Loader.scan_signatures`` lists a
        recipe's batch shapes from such samples without decoding a pixel."""
        rng = rng or np.random.default_rng()
        item = self.sample_clip(deepcopy(self.items[index]), rng)
        boxes = gt_box_alignment(item)  # [Nspan, 4] xyxy pixels
        # the plan draws before decode; decode consumes no randomness
        plan, boxes_out, text = self.transforms.plan(
            (item["height"], item["width"]), boxes, item["description"].lower(), rng)
        if plan_only:
            frames = np.zeros((len(item["frame_ids"]), item["height"], item["width"], 3),
                              np.uint8)
        else:
            frames = self.load_frames(item)
        return {
            "frames_u8": frames,
            "plan": plan,
            "boxes": boxes_out,
            "boxes_cxcywh": boxes_to_normalized_cxcywh(boxes_out, plan.out_hw),
            "text": text,
            "actioness": np.asarray(item["actioness"], np.float32),
            "item_id": item["item_id"],
            "frame_ids": item["frame_ids"],
            "ori_size": (item["height"], item["width"]),
            "qtype": item.get("qtype", "none"),
        }


class VidSTGDataset(GroundingDataset):
    def sample_clip(self, item, rng):
        return make_vidstg_input_clip(self.cfg, self.split, item, rng)

    def video_path(self, item):
        return os.path.join(self.data_dir, "videos", item["vid"] + ".mp4")


class HCSTVGDataset(GroundingDataset):
    def sample_clip(self, item, rng):
        return make_hcstvg_input_clip(self.cfg, self.split, item, rng)

    def video_path(self, item):
        return os.path.join(self.data_dir, "v1_video", item["vid"])


def build_dataset(cfg, split: str, transforms=None) -> GroundingDataset:
    if cfg.DATASET.NAME == "VidSTG":
        return VidSTGDataset(cfg, split, transforms)
    if cfg.DATASET.NAME == "HC-STVG":
        return HCSTVGDataset(cfg, split, transforms)
    raise ValueError(f"{cfg.DATASET.NAME} is not supported")
