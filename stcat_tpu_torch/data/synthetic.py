"""Synthetic dataset: procedurally rendered clips in the real cache format.

``write_synthetic_cache`` writes data-cache files of the real VidSTG /
HC-STVG schema, byte for byte what the JAX package's writes for the same
arguments; the frames are rendered on the fly (a bright rectangle drifting
along the GT tube over a smooth textured background), so cache loading,
clip sampling, transform plans, batching, training, evaluation and the vIoU
metrics all run without the benchmark videos. ``materialize_frame_corpus``
encodes them as JPEGs instead (it needs PIL), so that the frame-directory
decode path runs too; ``make_synthetic_dataset`` does so wherever PIL can
be imported.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import zlib
from typing import Dict

import numpy as np

from .annotations import _boundary_heatmaps, _dump, _load, cache_paths
from .datasets import GroundingDataset
from .sampling import make_hcstvg_input_clip, make_vidstg_input_clip

_SENTENCES = [
    "an adult grabs a white cup on the table",
    "a child in red walks toward the dog outside",
    "the man in the blue shirt rides a bicycle on the left",
    "a woman places a book on the shelf near the window",
    "what does the person in black hold in the kitchen",
    "the brown dog jumps over the fence on the right",
]


def write_synthetic_cache(data_dir: str, dataset: str = "VidSTG", split: str = "train",
                          n_items: int = 8, n_frames: int = 24, width: int = 96,
                          height: int = 72, seed: int = 0, vary_geometry: bool = False,
                          shared_span: bool = False) -> None:
    """Input and annotation caches of n_items synthetic clips.

    vary_geometry: each item's (width, height, frame_count) from a small
    spread, portrait orientations included. shared_span: every item gets the
    same GT temporal span (drawn once)."""
    # stable across processes (python's str hash is PYTHONHASHSEED-randomized)
    rng = np.random.default_rng(seed + zlib.crc32(split.encode()) % 1000)
    base_w, base_h, base_f = width, height, n_frames
    items, annos = [], []
    fixed_span = None
    for i in range(n_items):
        if vary_geometry:
            width = int(base_w * (1 + (i % 3)))
            height = int(base_h * (1 + ((i + 1) % 2)))
            n_frames = int(base_f * (1 + (i % 2)))
        if shared_span and fixed_span is not None:
            tg_begin, tg_end = fixed_span
            span_len = tg_end - tg_begin + 1
        else:
            span_len = int(rng.integers(max(4, n_frames // 4), max(5, n_frames // 2)))
            # degenerate corpora (n_frames < 8): keep >= one non-GT frame
            span_len = max(1, min(span_len, n_frames - 1))
            tg_begin = int(rng.integers(0, n_frames - span_len))
            tg_end = tg_begin + span_len - 1
            if shared_span:
                fixed_span = (tg_begin, tg_end)
        frame_ids = list(range(n_frames))
        actioness = np.asarray([float(tg_begin <= f <= tg_end) for f in frame_ids], np.float32)
        start_hm, end_hm = _boundary_heatmaps(actioness)
        bw, bh = rng.integers(width // 6, width // 3), rng.integers(height // 6, height // 3)
        x0 = rng.integers(0, width - bw - span_len - 1)
        y0 = rng.integers(0, height - bh - 1)
        bboxs = np.asarray([[x0 + k, y0, x0 + k + bw, y0 + bh] for k in range(span_len)],
                           np.float32)
        qtype = "declar" if i % 2 == 0 else "inter"
        item = {
            "item_id": i,
            "vid": f"synt_{split}_{i}",
            "frame_ids": frame_ids,
            "width": int(width),
            "height": int(height),
            "start_heatmap": start_hm.tolist(),
            "end_heatmap": end_hm.tolist(),
            "actioness": actioness.tolist(),
            "bboxs": bboxs.tolist(),
            "gt_temp_bound": [tg_begin, tg_end],
            "segment_bound": [0, n_frames - 1],
            "qtype": qtype,
            "description": _SENTENCES[i % len(_SENTENCES)],
            "object": "thing",
            "frame_count": n_frames,
        }
        anno = {
            "item_id": i,
            "vid": item["vid"],
            "bboxs": {str(fid): bboxs[fid - tg_begin].tolist()
                      for fid in range(tg_begin, tg_end + 1)},
            "description": item["description"],
            "qtype": qtype,
            "gt_temp_bound": [tg_begin, tg_end],
            "frame_count": n_frames,
        }
        items.append(item)
        annos.append(anno)
    input_path, anno_path = cache_paths(data_dir, dataset, split)
    _dump(items, input_path)
    _dump(annos, anno_path)


def render_frames(item: Dict, frame_ids) -> np.ndarray:
    """uint8 [T, h, w, 3]: a smooth drifting background with a fixed texture,
    and a white rectangle at the GT box inside the GT span."""
    h, w = item["height"], item["width"]
    tg_begin, tg_end = item["gt_temp_bound"]
    bboxs = np.asarray(item["bboxs"], np.float32)
    out = np.empty((len(frame_ids), h, w, 3), np.uint8)
    vid_seed = zlib.crc32(str(item["vid"]).encode()) % 100000
    yy = np.linspace(0, np.pi * 2, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, np.pi * 2, w, dtype=np.float32)[None, :]
    r0 = np.random.default_rng(vid_seed)
    phase = r0.uniform(0, np.pi * 2, size=3).astype(np.float32)
    texture = r0.integers(0, 16, size=(h, w, 3), dtype=np.uint8)
    for k, fid in enumerate(frame_ids):
        drift = 0.1 * fid
        img = np.empty((h, w, 3), np.uint8)
        for c in range(3):
            img[:, :, c] = (40 + 35 * (np.sin(yy + phase[c] + drift) * np.cos(xx - drift) + 1)
                            ).astype(np.uint8)
        img += texture
        if tg_begin <= fid <= tg_end:
            x0, y0, x1, y1 = bboxs[fid - tg_begin].astype(int)
            img[y0:y1, x0:x1] = 220
        out[k] = img
    return out


def materialize_frame_corpus(data_dir: str, dataset: str = "VidSTG", split: str = "train",
                             quality: int = 90) -> int:
    """Encode every cached item's frames as JPEGs under data_dir/frame/<vid>/
    (PIL), so the dataset takes its frame-directory decode path. Returns the
    number of frames written; items already on disk are skipped."""
    from PIL import Image

    input_path, _ = cache_paths(data_dir, dataset, split)
    n = 0
    for item in _load(input_path):
        vid_dir = os.path.join(data_dir, "frame", str(item["vid"]))
        if os.path.isdir(vid_dir):
            continue
        # staged, then published with one rename: no reader sees half a clip
        tmp_dir = f"{vid_dir}.tmp-{os.getpid()}"
        os.makedirs(tmp_dir, exist_ok=True)
        frames = render_frames(item, range(item["frame_count"]))
        for fid in range(item["frame_count"]):
            Image.fromarray(frames[fid]).save(os.path.join(tmp_dir, f"img_{fid:05d}.jpg"),
                                              quality=quality)
            n += 1
        try:
            os.rename(tmp_dir, vid_dir)
        except OSError:  # another process published first
            shutil.rmtree(tmp_dir, ignore_errors=True)
    return n


class SyntheticDataset(GroundingDataset):
    """Reads the synthetic cache; frames come from the JPEG corpus when it
    was materialised and are rendered otherwise. Clip sampling follows
    DATASET.NAME, so the synthetic twin stands in for either benchmark."""

    def sample_clip(self, item, rng):
        if self.cfg.DATASET.NAME == "HC-STVG":
            return make_hcstvg_input_clip(self.cfg, self.split, item, rng)
        return make_vidstg_input_clip(self.cfg, self.split, item, rng)

    def load_frames(self, item):
        if self._frame_dir(item) is not None:
            return super().load_frames(item)
        self.decode_routes.add("rendered")
        return render_frames(item, item["frame_ids"])


def make_synthetic_dataset(cfg, split: str, n_items: int = 8, n_frames: int = 24,
                           transforms=None, vary_geometry: bool = False,
                           shared_span: bool = False) -> SyntheticDataset:
    """The synthetic dataset of a split, its cache written on first use.
    Where PIL can be imported the JPEG corpus is written too (a no-op once
    on disk), so synthetic runs take the frame-directory decode path;
    without PIL the frames are rendered."""
    input_path, _ = cache_paths(cfg.DATA_DIR, cfg.DATASET.NAME, split)
    if not os.path.exists(input_path):
        write_synthetic_cache(cfg.DATA_DIR, cfg.DATASET.NAME, split, n_items=n_items,
                              n_frames=n_frames, vary_geometry=vary_geometry,
                              shared_span=shared_span)
    if importlib.util.find_spec("PIL") is not None:
        materialize_frame_corpus(cfg.DATA_DIR, cfg.DATASET.NAME, split)
    return SyntheticDataset(cfg, split, transforms)
