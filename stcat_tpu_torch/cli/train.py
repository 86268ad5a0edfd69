"""Training CLI.

    python -m stcat_tpu_torch.cli.train --config-file experiments/VidSTG/e2e_STCAT_R101_VidSTG.yaml \\
        OUTPUT_DIR out/ DATA_DIR /data/vidstg
    python -m stcat_tpu_torch.cli.train --synthetic --device cpu --max-iters 2 OUTPUT_DIR out/ ...

Trailing KEY VALUE pairs override the config. The run trains on ``cuda``
unless ``--device`` names another device; ``--synthetic`` trains on the
rendered synthetic dataset (data/synthetic.py) written under DATA_DIR. The
merged config is saved to OUTPUT_DIR/config.yml.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="STCAT training (PyTorch)")
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--synthetic", action="store_true", help="train on the synthetic dataset")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..config import default_config, merge_from_file, merge_from_list, save_config
    from ..core.dist import get_rank
    from ..core.logging import setup_logger
    from ..train.loop import train

    cfg = default_config()
    if args.config_file:
        cfg = merge_from_file(cfg, args.config_file)
    if args.opts:
        cfg = merge_from_list(cfg, args.opts)

    logger = setup_logger("stcat_tpu_torch", cfg.OUTPUT_DIR, rank=get_rank())
    logger.info(f"config file: {args.config_file}; device {args.device}")
    if cfg.OUTPUT_DIR and get_rank() == 0:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        save_config(cfg, os.path.join(cfg.OUTPUT_DIR, "config.yml"))

    dataset_builder = None
    if args.synthetic:
        from ..data.synthetic import make_synthetic_dataset

        def dataset_builder(c, split):
            return make_synthetic_dataset(c, split)

    train(cfg, dataset_builder=dataset_builder, logger=logger, max_iters=args.max_iters,
          device=args.device)


if __name__ == "__main__":
    main()
