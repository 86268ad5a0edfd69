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
evaluator writes OUTPUT_DIR/test_results.json. Under ``torchrun`` the
ranks evaluate on the mesh cfg.TPU describes (``cli/train.py``).
``--trace`` records the evaluation's spans (``eval.*`` and
``prefetch.place``, ``core/trace.py``) and writes them as a Chrome trace to
OUTPUT_DIR/trace/eval_rank<R>.json.
"""

from __future__ import annotations

import argparse
import json
import os

from . import add_common_args, dataset_builder, load_config
from . import add_dist_args, start


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="STCAT evaluation (PyTorch)")
    add_common_args(p)
    add_dist_args(p)
    p.add_argument("--synthetic", action="store_true", help="evaluate the synthetic dataset")
    p.add_argument("--trace", action="store_true",
                   help="write the evaluation's spans to OUTPUT_DIR/trace as a Chrome trace")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None):
    """The evaluator's summary (None off the main process)."""
    args = parse_args(argv)
    from ..core import trace
    from ..core.dist import get_rank
    from ..core.logging import setup_logger
    from ..data.loader import make_loader
    from ..data.tokenize import check_tokenizer_for_weights
    from ..eval.engine import do_eval
    from ..core.mesh import mesh_from_config
    from ..eval.evaluator import build_evaluator
    from ..models import build_model
    from ..train.checkpoint import load_weights_for_eval

    device = start(args)
    cfg = load_config(args.config_file, args.opts)
    if cfg.OUTPUT_DIR:  # the evaluator writes test_results.json there
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logger = setup_logger("stcat_tpu_torch", cfg.OUTPUT_DIR, rank=get_rank())
    mesh = mesh_from_config(cfg)
    logger.info(f"mesh: {mesh.size} device(s), shape {dict(mesh.shape)}")
    model = build_model(cfg, device, seed=cfg.SEED, mesh=mesh)
    loader = make_loader(cfg, dataset_builder(args.synthetic)(cfg, "test"), "test", mesh=mesh)
    check_tokenizer_for_weights(cfg, loader.tokenizer, cfg.MODEL.WEIGHT, what="evaluation")
    load_weights_for_eval(model, cfg.MODEL.WEIGHT, logger)
    if args.trace:
        trace.enable()
    res = do_eval(cfg, model, loader, build_evaluator(cfg, logger, "test"), logger)
    if args.trace:
        trace.disable()
        path = os.path.join(cfg.OUTPUT_DIR or ".", "trace", f"eval_rank{get_rank()}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": trace.chrome_events(trace.drain())}, f)
        logger.info(f"span trace written to {path}")
    if res is not None:
        logger.info(f"results: {res}")
    return res


if __name__ == "__main__":
    main()
