"""Ground one sentence in one clip from plain files: frames in, tube out.

    python -m stcat_tpu_torch.cli.infer --config-file experiments/VidSTG/e2e_STCAT_R101_VidSTG.yaml \\
        --frames /path/to/frame_dir --query "a dog jumps over the fence" \\
        [--out tube.json] [--draw outdir] [--weights out/run] [KEY VALUE ...]

The clip goes through the serving path (serve.py ``GroundingPredictor``:
on-device preprocess, the stacked two-stream forward, postprocess, the merge
back to the full frame rate), on ``cuda`` unless ``--device`` names another
device. ``--frames`` is a directory of image files (sorted by name, the
layout of the datasets' frame directories) or a .npy of uint8 [T, H, W, 3]
RGB; ``--stride`` takes every Nth frame. ``--weights`` defaults to
MODEL.WEIGHT. The tube is JSON, {"query", "span": [start, end), "boxes":
{frame index: [x0, y0, x1, y1]}, "frame_ids"} in original pixels, on stdout
or in ``--out``; the log goes to stderr. ``--draw`` writes each in-span
frame with its box as a JPEG. The KEY VALUE overrides come last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import add_common_args, load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="STCAT single-clip inference (PyTorch)")
    add_common_args(p)
    p.add_argument("--frames", required=True,
                   help="directory of image frames or a .npy [T,H,W,3] uint8")
    p.add_argument("--query", required=True, help="natural-language sentence")
    p.add_argument("--weights", default="",
                   help="checkpoint dir / reference .pth (default MODEL.WEIGHT)")
    p.add_argument("--out", default="", help="write the tube JSON here (default: stdout)")
    p.add_argument("--draw", default="",
                   help="also render the predicted box onto in-span frames as JPEGs here")
    p.add_argument("--stride", type=int, default=1, help="take every Nth frame")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def load_frames(path: str, stride: int = 1):
    """(frames uint8 [T, H, W, 3], frame_ids) from a directory or a .npy."""
    import numpy as np

    if stride < 1:
        raise SystemExit(f"--stride must be >= 1, got {stride}")
    if os.path.isdir(path):
        from PIL import Image

        names = sorted(n for n in os.listdir(path)
                       if n.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
        if not names:
            raise SystemExit(f"no image files in {path}")
        names = names[::stride]
        frames = np.stack([np.asarray(Image.open(os.path.join(path, n)).convert("RGB"))
                           for n in names])
        return frames.astype(np.uint8), [i * stride for i in range(len(names))]
    arr = np.load(path)
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise SystemExit(f"{path}: expected [T,H,W,3], got {arr.shape}")
    if arr.dtype != np.uint8:
        # astype(uint8) would truncate floats in [0, 1] to 0/1: rescale those,
        # refuse anything else
        if np.issubdtype(arr.dtype, np.floating) and arr.min() >= 0.0 and arr.max() <= 1.0:
            arr = np.round(arr * 255.0)
        else:
            raise SystemExit(f"{path}: expected uint8 pixels (or floats in [0,1]), got dtype "
                             f"{arr.dtype} with range [{arr.min()}, {arr.max()}]")
    arr = arr[::stride]
    return arr.astype(np.uint8), [i * stride for i in range(arr.shape[0])]


def draw_tube(frames, result, out_dir: str) -> int:
    """The predicted box drawn onto each in-span frame, saved as JPEGs;
    returns how many were written."""
    from PIL import Image, ImageDraw

    os.makedirs(out_dir, exist_ok=True)
    s, e = result["span"]
    n = 0
    for k, fid in enumerate(result["frame_ids"]):
        box = result["boxes"].get(fid)
        if not s <= fid < e or box is None:
            continue
        img = Image.fromarray(frames[k])
        ImageDraw.Draw(img).rectangle([box[0], box[1], box[2], box[3]], outline=(255, 32, 32),
                                      width=max(2, img.width // 200))
        img.save(os.path.join(out_dir, f"tube_{fid:05d}.jpg"), quality=92)
        n += 1
    return n


def run(cfg, args, logger):
    from ..serve import GroundingPredictor

    frames, frame_ids = load_frames(args.frames, args.stride)
    logger.info(f"clip: {frames.shape[0]} frames {frames.shape[2]}x{frames.shape[1]} | "
                f"query: {args.query!r}")
    predictor = GroundingPredictor(cfg, weights=args.weights, logger=logger, device=args.device)
    res = predictor.predict(frames, args.query, frame_ids=frame_ids)
    tube = {
        "query": args.query,
        "span": [int(res["span"][0]), int(res["span"][1])],
        "boxes": {int(f): [round(float(v), 2) for v in b] for f, b in sorted(res["boxes"].items())},
        "frame_ids": frame_ids,
    }
    if args.draw:
        logger.info(f"drew {draw_tube(frames, tube, args.draw)} annotated frame(s) into "
                    f"{args.draw}")
    payload = json.dumps(tube, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
        logger.info(f"tube written to {args.out}")
    else:
        print(payload)
    return tube


def main(argv=None):
    args = parse_args(argv)
    from ..core.logging import setup_logger
    from ..ops.misc import resolve_device

    resolve_device(args.device)
    cfg = load_config(args.config_file, args.opts)
    # without --out the tube is this process's stdout: the log goes to stderr
    logger = setup_logger("stcat_tpu_torch", cfg.OUTPUT_DIR, stream=sys.stderr)
    return run(cfg, args, logger)


if __name__ == "__main__":
    main()
