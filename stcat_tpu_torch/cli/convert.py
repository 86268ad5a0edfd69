"""Convert a reference STCAT or MDETR torch checkpoint into a port checkpoint
directory.

    python -m stcat_tpu_torch.cli.convert --src hcstvg_res448.pth \\
        --config-file experiments/HC-STVG/e2e_STCAT_R101_HCSTVG.yaml --out out/converted

The output directory holds ``checkpoints/`` as a training run writes it (step
0: the weights, EMA weights equal to them, no optimizer state) and
``provenance.json``. It then works as MODEL.WEIGHT for cli.test, cli.infer,
cli.serve and ``GroundingPredictor(weights=...)``; the tokenizer guard treats
it as reference-derived. Training cannot resume from it (no optimizer
state): ``Checkpointer.restore`` refuses it. An MDETR checkpoint (keys under
``transformer.``) initialises the sections it covers over a fresh model
drawn from SEED; a reference one must hold every weight.
"""

from __future__ import annotations

import argparse
import json
import os

from . import add_common_args, load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="STCAT checkpoint converter (PyTorch)")
    p.add_argument("--src", required=True, help="reference or MDETR torch .pth")
    p.add_argument("--out", required=True, help="output checkpoint directory")
    add_common_args(p)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..core.logging import setup_logger
    from ..models import build_model
    from ..ops.misc import resolve_device
    from ..train.checkpoint import Checkpointer, load_torch_file
    from ..train.convert_reference import load_reference_state_dict, remap_mdetr
    from ..train.step import TrainState

    device = resolve_device(args.device)
    cfg = load_config(args.config_file, args.opts)
    logger = setup_logger("stcat_tpu_torch.convert", args.out)
    sd = load_torch_file(args.src)
    is_mdetr = any(k.startswith("transformer.") for k in sd)
    model = build_model(cfg, device, seed=cfg.SEED)
    if is_mdetr:
        logger.info("MDETR-style checkpoint: partial init over fresh weights")
        loaded = load_reference_state_dict(model, remap_mdetr(sd), strict=False, logger=logger)
    else:
        loaded = load_reference_state_dict(model, sd, logger=logger)
    logger.info(f"{len(loaded)} weights taken from {args.src}")
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    Checkpointer(args.out, logger).save(0, TrainState(step=0, model=model, optimizer=None,
                                                      ema=ema), block=True)
    # the tokenizer guard reads this marker (data/tokenize.py)
    with open(os.path.join(args.out, "provenance.json"), "w") as f:
        json.dump({"converted_from_reference": True, "src": args.src,
                   "mdetr_partial_init": bool(is_mdetr)}, f)
    logger.info(f"converted checkpoint written to {os.path.join(args.out, 'checkpoints')}")
    return args.out


if __name__ == "__main__":
    main()
