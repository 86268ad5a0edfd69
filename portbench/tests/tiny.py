"""Tiny-width stand-ins of the benchmark's configurations and mixes, for
rehearsing a cell end to end on the CPU (torch only)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent

TINY_SIZES = {
    "INPUT": {"RESOLUTION": 64, "TRAIN_SAMPLE_NUM": 8, "MAX_VIDEO_LEN": 64},
    "MODEL": {"VISION_BACKBONE": {"DEPTHS": [1, 1, 1, 1]},
              "TEXT_MODEL": {"VOCAB_SIZE": 1000, "HIDDEN": 32, "LAYERS": 2, "HEADS": 2,
                             "INTERMEDIATE": 64, "MAX_POS": 64},
              "STCAT": {"HIDDEN": 32, "HEADS": 2, "FFN_DIM": 64, "ENC_LAYERS": 1,
                        "DEC_LAYERS": 2}},
    "DATALOADER": {"NUM_WORKERS": 2},
    "SOLVER": {"MAX_EPOCH": 200},
    "TPU": {"FRAME_BUCKETS": [8, 16], "COMPUTE_DTYPE": "float32"},
}


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst.setdefault(k, {}), v)
        else:
            dst[k] = v
    return dst


def tiny_conf(name: str, **overrides) -> dict:
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    conf = copy.deepcopy(conf)
    _merge(conf["config"], copy.deepcopy(TINY_SIZES))
    _merge(conf["config"], overrides)
    return conf


def tiny_traffic(name: str) -> dict:
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    t.update({"videos": 2, "frames_per_video": 40,
              "segment_frames": [20, 40], "span_frames": [8, 15]})
    if t["kind"] == "serve":
        t.update({"request_frames": 16, "rate": 4.0, "check_requests": 2})
    elif t["kind"] == "eval":
        t.update({"items": 6, "check_clips": 2})
    else:
        t["items"] = 6
    return t
