"""The one generator of the benchmark's inputs, driven by a traffic file.

A traffic file (``traffic/<name>.json``) gives the parameters: the kind of
run (``train``, ``eval`` or ``serve``), the dataset schema, the frame
geometry, how many videos, frames and annotated items, the layout seed of
the annotations, the sentences, and for serving the request lengths and the
arrival rate and shape. From them and the run's seed this module makes:

  * a JPEG frame corpus (``DATA_DIR/frame/<vid>/img_NNNNN.jpg``) and the
    data cache of the port's VidSTG / HC-STVG schema for one split
    (``write_corpus``);
  * in-memory request clips (``request_clips``), each request's length
    (``request_lengths``) and open-loop arrival times (``arrivals``), whose
    shape the mix names.

The annotation layout (segments, spans, boxes) comes from the traffic's
``layout_seed`` alone, so every seed gives the loader the same clip lengths
and augmentation draws, hence the same batch shapes; the pixels, sentences
and weights come from the run's seed.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Tuple

import numpy as np

CACHE_TAG = {"VidSTG": "vidstg", "HC-STVG": "hcstvg"}


def cache_paths(data_dir: str, dataset: str, split: str) -> Tuple[str, str]:
    """The port's data-cache file names for a split."""
    base = os.path.join(data_dir, "data_cache", f"{CACHE_TAG[dataset]}-{split}")
    return base + "-input.json.gz", base + "-anno.json.gz"


def frames_of(seed: int, video: int, n: int, hw: Tuple[int, int]) -> np.ndarray:
    """uint8 [n, h, w, 3]: a colour that changes from frame to frame over a
    fixed noise texture that drifts sideways, so the model's outputs differ
    between frames (at random weights, frames alike make every span a tie)."""
    rng = np.random.default_rng([seed % (2 ** 63), video])
    h, w = hw
    phase = rng.uniform(0, 2 * np.pi, 3)
    t = np.arange(n)[:, None]
    colour = 128 + 100 * np.sin(2 * np.pi * t / n * np.array([1.0, 2.0, 3.0]) + phase)
    texture = rng.normal(0, 30, (h, w + n, 3)).astype(np.float32)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        out[i] = np.clip(colour[i].astype(np.float32) + texture[:, i: i + w], 0, 255)
    return out


def sentences(traffic: Dict, seed: int, n: int) -> List[str]:
    rng = np.random.default_rng([seed % (2 ** 63), 7])
    pool = traffic["sentences"]
    return [pool[int(i)] for i in rng.integers(0, len(pool), n)]


def _heatmap(n: int, idx: int) -> List[float]:
    eps = 1e-10
    pseudo = (1 - (n - 3) * eps - 0.5) / 2
    h = np.full(n, eps)
    h[idx] = 0.5
    if idx > 0:
        h[idx - 1] = pseudo
    if idx < n - 1:
        h[idx + 1] = pseudo
    return h.tolist()


def layout(traffic: Dict) -> List[Dict]:
    """The annotated items, from ``layout_seed``: each names a video, a
    segment of it, the ground-truth span inside the segment and a box per
    span frame drifting across the frame."""
    rng = np.random.default_rng(int(traffic["layout_seed"]))
    w, h = traffic["width"], traffic["height"]
    n_video = traffic["videos"]
    lo, hi = traffic["segment_frames"]
    s_lo, s_hi = traffic["span_frames"]
    items = []
    for i in range(traffic["items"]):
        n0 = int(rng.integers(lo, hi + 1))
        first = int(rng.integers(0, traffic["frames_per_video"] - n0 + 1))
        span = int(rng.integers(s_lo, min(s_hi, n0 - 2) + 1))
        s = int(rng.integers(1, n0 - span))
        bw, bh = int(rng.integers(w // 6, w // 3)), int(rng.integers(h // 6, h // 3))
        x0 = float(rng.uniform(0, w - bw - span * 0.5 - 1))
        y0 = float(rng.uniform(0, h - bh - 1))
        boxes = [[x0 + 0.5 * k, y0, x0 + 0.5 * k + bw, y0 + bh] for k in range(span)]
        items.append({"video": int(rng.integers(0, n_video)), "first": first, "n0": n0,
                      "span": (s, s + span - 1), "boxes": boxes,
                      "qtype": "declar" if i % 2 == 0 else "inter"})
    return items


def write_corpus(traffic: Dict, seed: int, data_dir: str) -> Dict:
    """Write the split's JPEG frames and data cache under ``data_dir``;
    returns {"items": cache items, "frames": JPEG count}."""
    from PIL import Image

    dataset, split = traffic["dataset"], traffic["split"]
    hw = (traffic["height"], traffic["width"])
    n_frames = traffic["frames_per_video"]
    written = 0
    for v in range(traffic["videos"]):
        vid_dir = os.path.join(data_dir, "frame", f"video{v}")
        os.makedirs(vid_dir, exist_ok=True)
        for fid, frame in enumerate(frames_of(seed, v, n_frames, hw)):
            Image.fromarray(frame).save(os.path.join(vid_dir, f"img_{fid:05d}.jpg"), quality=90)
            written += 1
    texts = sentences(traffic, seed, traffic["items"])
    items, annos = [], []
    for i, (it, text) in enumerate(zip(layout(traffic), texts)):
        fids = list(range(it["first"], it["first"] + it["n0"]))
        s, e = it["span"]
        act = [float(s <= k <= e) for k in range(it["n0"])]
        bound = [fids[s], fids[e]]
        vid = f"video{it['video']}"
        items.append({
            "item_id": i, "vid": vid, "frame_ids": fids, "width": hw[1], "height": hw[0],
            "start_heatmap": _heatmap(it["n0"], s), "end_heatmap": _heatmap(it["n0"], e),
            "actioness": act, "bboxs": it["boxes"], "gt_temp_bound": bound,
            "segment_bound": [fids[0], fids[-1]], "qtype": it["qtype"], "description": text,
            "object": "person", "frame_count": n_frames,
        })
        annos.append({
            "item_id": i, "vid": vid,
            "bboxs": {str(fids[k]): it["boxes"][k - s] for k in range(s, e + 1)},
            "description": text, "qtype": it["qtype"], "gt_temp_bound": bound,
            "frame_count": n_frames,
        })
    for obj, path in zip((items, annos), cache_paths(data_dir, dataset, split)):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with gzip.open(path, "wt") as f:
            json.dump(obj, f)
    return {"items": items, "frames": written}


def request_lengths(traffic: Dict, n: int, seed: int) -> np.ndarray:
    """The frames of each of ``n`` requests. ``request_frames`` is one
    number (every request) or a list of [frames, share] pairs: round(share x
    n) requests of each length (the last length takes what rounding
    leaves), in an order drawn from the run's seed, so every seed offers the
    same set of lengths."""
    spec = traffic["request_frames"]
    if isinstance(spec, (int, float)):
        return np.full(n, int(spec), np.int64)
    counts = [int(round(share * n)) for _, share in spec[:-1]]
    counts.append(max(0, n - sum(counts)))
    lengths = np.repeat([int(f) for f, _ in spec], counts)[:n]
    return lengths[np.random.default_rng([seed % (2 ** 63), 17]).permutation(len(lengths))]


def length_set(traffic: Dict) -> List[int]:
    """The mix's request lengths, shortest first."""
    spec = traffic["request_frames"]
    return [int(spec)] if isinstance(spec, (int, float)) else sorted(int(f) for f, _ in spec)


def request_clips(traffic: Dict, seed: int) -> List[np.ndarray]:
    """The pool of request clips, uint8 [frames, h, w, 3] each, at the
    longest request length; a shorter request takes a clip's first frames."""
    hw = (traffic["height"], traffic["width"])
    return [frames_of(seed, v, length_set(traffic)[-1], hw) for v in range(traffic["videos"])]


def arrivals(traffic: Dict, seconds: float, seed: int, rate: float = None) -> np.ndarray:
    """Open-loop arrival times in [0, seconds) at ``rate`` (default: the
    mix's ``rate``): round(rate x seconds) requests whose gaps are
    exponential draws from ``layout_seed``, in an order drawn from the run's
    seed, so every seed offers the same number of requests and the same set
    of gaps. ``arrival`` names the shape: "poisson" (the default) spreads
    the gaps over the window; "onoff" spreads them over the ``on_s`` second
    bursts that follow each ``off_s`` second pause (the window opens on a
    burst), the same mean rate in bursts of rate x (on_s + off_s) / on_s."""
    rate = traffic["rate"] if rate is None else rate
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng([int(traffic["layout_seed"]), 11]).exponential(1.0, n)
    shape = traffic.get("arrival", "poisson")
    if shape == "poisson":
        on, period = seconds, seconds
    elif shape == "onoff":
        on, period = float(traffic["on_s"]), float(traffic["on_s"]) + float(traffic["off_s"])
    else:
        raise ValueError(f"arrival {shape!r}: poisson or onoff")
    bursts, rest = divmod(seconds, period)
    busy = bursts * on + min(rest, on)
    gaps *= busy / gaps.sum()
    gaps = gaps[np.random.default_rng([seed % (2 ** 63), 11]).permutation(n)]
    t = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return np.floor(t / on) * period + np.mod(t, on)
