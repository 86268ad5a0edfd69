"""Training CLI.

    python -m stcat_tpu_torch.cli.train --config-file experiments/VidSTG/e2e_STCAT_R101_VidSTG.yaml \\
        OUTPUT_DIR out/ DATA_DIR /data/vidstg
    python -m stcat_tpu_torch.cli.train --synthetic --device cpu --max-iters 2 OUTPUT_DIR out/ ...

Trailing KEY VALUE pairs override the config. The run trains on ``cuda``
unless ``--device`` names another device; ``--synthetic`` trains on the
rendered synthetic dataset (data/synthetic.py) written under DATA_DIR. The
merged config is saved to OUTPUT_DIR/config.yml. Under ``torchrun`` every
rank trains its part of the mesh cfg.TPU describes (MESH_DATA,
MODEL_PARALLEL, SEQUENCE_PARALLEL, MESH_SEQ):

    torchrun --nproc-per-node 4 -m stcat_tpu_torch.cli.train --dist-backend nccl \
        --config-file experiments/VidSTG/e2e_STCAT_R101_VidSTG.yaml TPU.MODEL_PARALLEL 2 ...
"""

from __future__ import annotations

import argparse
import os

from . import add_common_args, dataset_builder, load_config
from . import add_dist_args, start


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="STCAT training (PyTorch)")
    add_common_args(p)
    add_dist_args(p)
    p.add_argument("--synthetic", action="store_true", help="train on the synthetic dataset")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..config import save_config
    from ..core.dist import get_rank
    from ..core.logging import setup_logger
    from ..train.loop import train

    device = start(args)
    cfg = load_config(args.config_file, args.opts)

    logger = setup_logger("stcat_tpu_torch", cfg.OUTPUT_DIR, rank=get_rank())
    logger.info(f"config file: {args.config_file}; device {device}")
    if cfg.OUTPUT_DIR and get_rank() == 0:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        save_config(cfg, os.path.join(cfg.OUTPUT_DIR, "config.yml"))

    train(cfg, dataset_builder=dataset_builder(args.synthetic), logger=logger,
          max_iters=args.max_iters, device=device)


if __name__ == "__main__":
    main()
