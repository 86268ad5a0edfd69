"""Evaluation CLI: MODEL.WEIGHT over the test split.

    python -m stcat_tpu_torch.cli.test --config-file experiments/VidSTG/e2e_STCAT_R101_VidSTG.yaml \\
        MODEL.WEIGHT out/ OUTPUT_DIR out/ DATA_DIR /data/vidstg
    python -m stcat_tpu_torch.cli.test --synthetic --device cpu MODEL.WEIGHT out/ OUTPUT_DIR out/ ...

Trailing KEY VALUE pairs override the config. MODEL.WEIGHT is a training
run's OUTPUT_DIR (EMA weights preferred), a converted checkpoint directory
(cli/convert.py) or a reference-named torch file; the tokenizer guard refuses
reference-derived weights under the stand-in hash tokenizer. The run
evaluates on ``cuda`` unless ``--device`` names another device;
``--synthetic`` evaluates the rendered synthetic test split (written under
DATA_DIR on first use). The metrics are logged and returned, and the
evaluator writes OUTPUT_DIR/test_results.json.
"""

from __future__ import annotations

import argparse
import os

from . import add_common_args, dataset_builder, load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="STCAT evaluation (PyTorch)")
    add_common_args(p)
    p.add_argument("--synthetic", action="store_true", help="evaluate the synthetic dataset")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None):
    """The evaluator's summary (None off the main process)."""
    args = parse_args(argv)
    from ..core.dist import get_rank
    from ..core.logging import setup_logger
    from ..data.loader import make_loader
    from ..data.tokenize import check_tokenizer_for_weights
    from ..eval.engine import do_eval
    from ..eval.evaluator import build_evaluator
    from ..models import build_model
    from ..ops.misc import resolve_device
    from ..train.checkpoint import load_weights_for_eval

    device = resolve_device(args.device)
    cfg = load_config(args.config_file, args.opts)
    if cfg.OUTPUT_DIR:  # the evaluator writes test_results.json there
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logger = setup_logger("stcat_tpu_torch", cfg.OUTPUT_DIR, rank=get_rank())
    model = build_model(cfg, device, seed=cfg.SEED)
    loader = make_loader(cfg, dataset_builder(args.synthetic)(cfg, "test"), "test")
    check_tokenizer_for_weights(cfg, loader.tokenizer, cfg.MODEL.WEIGHT, what="evaluation")
    load_weights_for_eval(model, cfg.MODEL.WEIGHT, logger)
    res = do_eval(cfg, model, loader, build_evaluator(cfg, logger, "test"), logger)
    if res is not None:
        logger.info(f"results: {res}")
    return res


if __name__ == "__main__":
    main()
