"""The learning proof of tests/test_learning.py, run on the port (torch only).

    res = overfit(tmp_dir, device="cpu")        # or "cuda", with extra opts
    check(res)

The tiny model overfits two synthetic 12-frame clips that share one span
(``shared_span=True``) for 900 iterations through ``train.loop.train``, and
``run_validation`` then evaluates it on the same two clips (the train cache
copied over the test split's paths), once in fp32 and once re-evaluating the
same weights with ``TPU.COMPUTE_DTYPE bfloat16``. tests/test_learning.py
says why each option is what it is. ``check`` holds the result to that
test's thresholds. This module imports neither JAX nor the JAX package, so
``chip_smoke.py`` runs it on the card; tests/test_torch_learning.py runs it
on the CPU and holds its config to the JAX test's.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from stcat_tpu_torch.config import default_config, merge_from_list
from stcat_tpu_torch.core.logging import setup_logger
from stcat_tpu_torch.core.mesh import mesh_from_config
from stcat_tpu_torch.data.annotations import cache_paths
from stcat_tpu_torch.data.synthetic import make_synthetic_dataset
from stcat_tpu_torch.models import build_model
from stcat_tpu_torch.train.loop import run_validation, train

ITERS = 900
# tests/helpers.py::tiny_cfg's options
TINY_OPTS = [
    "MODEL.VISION_BACKBONE.NAME", "resnet50", "MODEL.VISION_BACKBONE.DEPTHS", "[1,1,1,1]",
    "MODEL.STCAT.ENC_LAYERS", 2, "MODEL.STCAT.DEC_LAYERS", 2, "MODEL.STCAT.HIDDEN", 64,
    "MODEL.STCAT.HEADS", 4, "MODEL.STCAT.FFN_DIM", 128, "INPUT.MAX_VIDEO_LEN", 32,
    "MODEL.TEXT_MODEL.VOCAB_SIZE", 128, "MODEL.TEXT_MODEL.HIDDEN", 32,
    "MODEL.TEXT_MODEL.LAYERS", 2, "MODEL.TEXT_MODEL.HEADS", 2,
    "MODEL.TEXT_MODEL.INTERMEDIATE", 64, "MODEL.TEXT_MODEL.MAX_POS", 64,
    "TPU.COMPUTE_DTYPE", "float32", "TPU.REMAT_BACKBONE", "false",
]
# tests/test_learning.py::test_overfit_moves_m_viou's options after DATA_DIR, OUTPUT_DIR
LEARN_OPTS = [
    "INPUT.RESOLUTION", 64, "INPUT.TRAIN_SAMPLE_NUM", 8, "INPUT.MAX_QUERY_LEN", 12,
    "INPUT.AUG_SCALE", "false", "INPUT.AUG_CROP", "false", "INPUT.FLIP_PROB_TRAIN", 0.0,
    "INPUT.TEMP_CROP_PROB", 0.0, "MODEL.EMA", "false",
    "SOLVER.BASE_LR", 1e-3, "SOLVER.VIS_BACKBONE_LR", 1e-3, "SOLVER.TEXT_LR", 1e-3,
    "SOLVER.TEMP_LR", 1e-3, "SOLVER.WARMUP_PROP", 0.0,
    "SOLVER.SCHEDULE.TYPE", "multistep_with_warmup_all", "SOLVER.SCHEDULE.DROP_STEP", "[100000]",
    "SOLVER.MAX_EPOCH", 100000, "SOLVER.VAL_PERIOD", 1000000,
    "SOLVER.CHECKPOINT_PERIOD", 1000000, "TPU.FRAME_BUCKETS", "[8,16]", "TPU.MESH_DATA", 1,
    "DATALOADER.NUM_WORKERS", 0,
]
# tests/test_learning.py's thresholds
MIN_VIOU, MIN_QTYPE_VIOU, MAX_BF16_DRIFT = 0.30, 0.15, 0.05


def learning_cfg(tmp: str, extra=()):
    return merge_from_list(default_config(), TINY_OPTS + [
        "DATA_DIR", str(tmp), "OUTPUT_DIR", os.path.join(str(tmp), "out")] + LEARN_OPTS
        + list(extra))


def builder(c, split):
    if split != "train":
        # evaluate on the trained clips (tests/test_learning.py's docstring)
        make_synthetic_dataset(c, "train", n_items=2, n_frames=12, shared_span=True)
        for src, dst in zip(cache_paths(c.DATA_DIR, c.DATASET.NAME, "train"),
                            cache_paths(c.DATA_DIR, c.DATASET.NAME, split)):
            if not os.path.exists(dst):
                shutil.copy(src, dst)
    return make_synthetic_dataset(c, split, n_items=2, n_frames=12, shared_span=True)


def viou(res: dict) -> float:
    """The mean of the per-query-type vIoUs (the bare 'viou' on HC-STVG),
    never the GT-span-only ones."""
    keys = [k for k in res if (k == "viou" or k.endswith("_viou")) and "gt_viou" not in k]
    if not keys:
        raise AssertionError(f"no vIoU keys in {sorted(res)}")
    return float(np.mean([res[k] for k in keys]))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def overfit(tmp: str, device=None, extra=(), iters: int = ITERS) -> dict:
    """Train ``iters`` iterations, then validate in fp32 and in bf16 compute.
    Returns both metric dicts, their drifts and the seconds of each part."""
    cfg = learning_cfg(tmp, extra)
    logger = setup_logger("learn", rank=0)
    t0 = time.perf_counter()
    state, it = train(cfg, builder, logger=logger, max_iters=iters, device=device)
    dev = next(state.model.parameters()).device
    _sync(dev)
    train_s = time.perf_counter() - t0
    if it != iters:
        raise AssertionError(f"train() returned at iteration {it}, expected {iters}")

    mesh = mesh_from_config(cfg)
    t0 = time.perf_counter()
    res = run_validation(cfg, build_model(cfg, dev, seed=cfg.SEED, mesh=mesh), state, builder,
                         logger)
    _sync(dev)
    val_s = time.perf_counter() - t0
    cfg_bf16 = merge_from_list(cfg, ["TPU.COMPUTE_DTYPE", "bfloat16"])
    t0 = time.perf_counter()
    res_bf16 = run_validation(cfg_bf16, build_model(cfg_bf16, dev, seed=cfg.SEED, mesh=mesh),
                              state, builder, logger)
    _sync(dev)
    val_bf16_s = time.perf_counter() - t0
    tiou_keys = [k for k in res if k.endswith("tiou")]
    return {
        "iterations": it, "res": res, "res_bf16": res_bf16,
        "viou": viou(res), "viou_bf16": viou(res_bf16),
        "viou_drift": abs(viou(res_bf16) - viou(res)),
        "tiou_drift": max(abs(res_bf16[k] - res[k]) for k in tiou_keys),
        "drift": {k: res_bf16[k] - res[k] for k in res},
        "train_s": train_s, "val_s": val_s, "val_bf16_s": val_bf16_s,
    }


def misses(out: dict) -> list:
    """tests/test_learning.py's assertions on an ``overfit`` result that
    fail, as messages."""
    res = out["res"]
    failed = []
    # a trained model localizes the tube in space and time on both clips
    if not out["viou"] > MIN_VIOU:
        failed.append(f"m_vIoU {out['viou']:.4f} <= {MIN_VIOU}")
    # a positional shortcut scores ~0 on one query type
    for k in ("declar_viou", "inter_viou"):
        if not res[k] > MIN_QTYPE_VIOU:
            failed.append(f"{k} {res[k]:.4f} <= {MIN_QTYPE_VIOU}")
    for k in ("viou_drift", "tiou_drift"):
        if not out[k] < MAX_BF16_DRIFT:
            failed.append(f"bf16 {k} {out[k]:.4f} >= {MAX_BF16_DRIFT}")
    return failed


def check(out: dict) -> None:
    """tests/test_learning.py's assertions on an ``overfit`` result, raised
    explicitly."""
    failed = misses(out)
    if failed:
        raise AssertionError(f"{'; '.join(failed)}: fp32 {out['res']}, bf16 {out['res_bf16']}")
