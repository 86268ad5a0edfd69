"""Cache-backed VidSTG / HC-STVG datasets.

``__getitem__(index, rng)`` samples a clip, draws its transform plan and
returns a raw sample for ``data/batching.py::build_raw_batch``: the decoded,
untransformed pixels (rgb uint8 frames [T, h, w, 3], or with
``TPU.INGEST_LAYOUT yuv420`` a luma plane [T, h, w] and a chroma plane
[T, ceil(h/2), ceil(w/2), 2]), the TransformPlan, boxes_cxcywh of the
GT-span frames, actioness [T], the sentence and the clip's metadata; the
card resamples and normalises the pixels (``ops/preprocess.py``). With
``raw=False`` (the loader's ``TPU.DEVICE_PREPROCESS false``) the host does
that pixel work and the sample carries normalised float32 ``frames`` for
``build_batch``. Both draw the same rng stream, so the targets agree.
``decode_routes`` counts the decoder that served each clip.
"""

from __future__ import annotations

import os
import threading
from copy import deepcopy
from typing import Dict, Optional

import numpy as np

from .annotations import load_or_build_cache
from .decode import (DecodeRoutes, decode_frames, load_frame_images, load_frame_images_yuv,
                     rgb_to_yuv420)
from .sampling import gt_box_alignment, make_hcstvg_input_clip, make_vidstg_input_clip
from .transforms import VideoTransform, boxes_to_normalized_cxcywh, build_transforms

_pool_lock = threading.Lock()


class GroundingDataset:
    """Common machinery of both benchmarks."""

    # the loader may ask for raw samples (TPU.DEVICE_PREPROCESS)
    supports_raw = True
    # the native ffmpeg pipe pool, shared by every dataset of the process;
    # False once it could not be built
    _frame_pool = None

    def __init__(self, cfg, split: str, transforms: Optional[VideoTransform] = None):
        self.cfg = cfg
        self.split = split
        self.transforms = transforms or build_transforms(cfg, split == "train")
        self.data_dir = cfg.DATA_DIR
        self.items, self.annos = load_or_build_cache(cfg.DATA_DIR, cfg.DATASET.NAME, split,
                                                     seed=cfg.SEED)
        if cfg.DATA_TRUNK is not None:
            self.items = self.items[: cfg.DATA_TRUNK]
        self.decode_routes = DecodeRoutes()

    def __len__(self) -> int:
        return len(self.items)

    def sample_clip(self, item: Dict, rng) -> Dict:
        raise NotImplementedError

    def video_path(self, item: Dict) -> str:
        raise NotImplementedError

    @staticmethod
    def _native_pool():
        """The shared FramePool, built at first use; None without one."""
        with _pool_lock:
            if GroundingDataset._frame_pool is None:
                from . import native_decode

                GroundingDataset._frame_pool = (native_decode.FramePool(workers=4)
                                                if native_decode.available() else False)
            return GroundingDataset._frame_pool or None

    def _frame_dir(self, item: Dict) -> Optional[str]:
        """DATA_DIR/frame when it holds the item's video as JPEG frames."""
        frame_dir = os.path.join(self.data_dir, "frame")
        return frame_dir if os.path.isdir(os.path.join(frame_dir, str(item["vid"]))) else None

    def load_frames(self, item: Dict) -> np.ndarray:
        """uint8 [T, H, W, 3] of the sampled frame_ids: from the frame
        directory when the video has one (native libjpeg, else PIL), else
        decoded by ffmpeg (the native pipe pool, else one subprocess)."""
        frame_dir = self._frame_dir(item)
        if frame_dir is not None:
            return load_frame_images(frame_dir, str(item["vid"]), item["frame_ids"],
                                     (item["height"], item["width"]), self.decode_routes)
        pool = self._native_pool()
        if pool is not None:
            from .native_decode import decode_frames_native

            try:
                frames = decode_frames_native(pool, self.video_path(item), item["frame_ids"],
                                              item["height"], item["width"])
                self.decode_routes.add("framepool")
                return frames
            except RuntimeError:
                pass  # the subprocess path below, with its retries
        self.decode_routes.add("subprocess")
        return decode_frames(self.video_path(item), item["frame_ids"], item["height"],
                             item["width"])

    def load_frames_yuv(self, item: Dict):
        """4:2:0 planes (y, cbcr) of the sampled frame_ids: a frame directory
        decodes straight to the codec's YCbCr (natively; PIL converts), a
        video's decoded RGB is converted here."""
        frame_dir = self._frame_dir(item)
        if frame_dir is not None:
            return load_frame_images_yuv(frame_dir, str(item["vid"]), item["frame_ids"],
                                         (item["height"], item["width"]), self.decode_routes)
        return rgb_to_yuv420(self.load_frames(item))

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None,
                    raw: bool = True, plan_only: bool = False) -> Dict:
        """A raw sample (``raw``, the default) or a host-transformed one.

        ``plan_only`` (raw only): zero-filled pixels of the decode shapes
        instead of decoded ones. The rng stream is the same (the plan draws
        before decode, and decode draws nothing), so the sample's shapes,
        plan and targets are those of the real one: ``Loader.scan_signatures``
        lists a recipe's batch shapes from such samples without decoding a
        pixel."""
        if plan_only and not raw:
            raise ValueError("plan_only samples are raw samples")
        rng = rng or np.random.default_rng()
        item = self.sample_clip(deepcopy(self.items[index]), rng)
        boxes = gt_box_alignment(item)  # [Nspan, 4] xyxy pixels
        meta = {
            "actioness": np.asarray(item["actioness"], np.float32),
            "item_id": item["item_id"],
            "frame_ids": item["frame_ids"],
            "ori_size": (item["height"], item["width"]),
            "qtype": item.get("qtype", "none"),
        }
        if not raw:
            frames = self.load_frames(item).astype(np.float32) / 255.0
            sample = {"frames": frames, "boxes": boxes, "text": item["description"].lower(),
                      **meta}
            return self.transforms(sample, rng)
        # the plan draws before decode; decode consumes no randomness
        plan, boxes_out, text = self.transforms.plan(
            (item["height"], item["width"]), boxes, item["description"].lower(), rng)
        t, h, w = len(item["frame_ids"]), item["height"], item["width"]
        if self.cfg.TPU.INGEST_LAYOUT == "yuv420":
            if plan_only:
                y = np.zeros((t, h, w), np.uint8)
                cbcr = np.zeros((t, (h + 1) // 2, (w + 1) // 2, 2), np.uint8)
            else:
                y, cbcr = self.load_frames_yuv(item)
            pixels = {"frames_y": y, "frames_cbcr": cbcr}
        elif plan_only:
            pixels = {"frames_u8": np.zeros((t, h, w, 3), np.uint8)}
        else:
            pixels = {"frames_u8": self.load_frames(item)}
        return {
            **pixels,
            "plan": plan,
            "boxes": boxes_out,
            "boxes_cxcywh": boxes_to_normalized_cxcywh(boxes_out, plan.out_hw),
            "text": text,
            **meta,
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
