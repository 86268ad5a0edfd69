"""Warm-up and preflight of a recipe's batch shapes.

    python -m stcat_tpu_torch.cli.precompile --config-file experiments/VidSTG/e2e_STCAT_R101_VidSTG.yaml \\
        DATA_DIR /data/vidstg OUTPUT_DIR out/
    python -m stcat_tpu_torch.cli.precompile ... --list        # the inventory only

With multi-scale augmentation a run meets several batch shapes, (B, frame
bucket, source canvas, output canvas, layout) signatures. This tool lists
every signature a recipe will produce without decoding a pixel
(``Loader.scan_signatures`` replays the loader's epoch and sample generators
through plan-only samples), per split, rgb or yuv420 by TPU.INGEST_LAYOUT
(the host pixel path, ``TPU.DEVICE_PREPROCESS false``, is refused: its
shapes key only on the frame bucket and resolution). Without ``--list`` it then builds the
kernels into ``stcat_tpu_torch/_build/``, runs each train signature once
through ``make_train_step`` (K1, K2, K3 and the step's optimizer update) and
each eval signature once through the eval forward and ``postprocess``, in the
TPU.EVAL_DEVICE_SPLIT variant the config selects, and logs the seconds and
the card's peak memory of each. A signature that does not fit the card fails
here, not mid-epoch. The port compiles nothing per shape: what persists is
the kernel build directory, and cuDNN picks its algorithms again in each
process. ``--max-iters`` takes cli.train's value (it sets the schedule's
horizon), ``--epochs`` the train epochs to scan (0: SOLVER.MAX_EPOCH; the
augmentation draws differ per epoch, eval is one pass), ``--mode`` the
splits, ``--synthetic`` the synthetic dataset. Runs on ``cuda`` unless
``--device`` names another device; under ``torchrun`` each rank scans its
data rank's shard and runs its part of the mesh cfg.TPU describes.
"""

from __future__ import annotations

import argparse
import time

from . import add_common_args, dataset_builder, load_config
from . import add_dist_args, start


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="STCAT batch-shape warm-up (PyTorch)")
    add_common_args(p)
    add_dist_args(p)
    p.add_argument("--mode", choices=["train", "eval", "both"], default="both")
    p.add_argument("--epochs", type=int, default=0,
                   help="train epochs to scan (0: SOLVER.MAX_EPOCH, the epochs the run draws)")
    p.add_argument("--list", action="store_true", help="list the signatures and stop")
    p.add_argument("--max-iters", type=int, default=None,
                   help="cli.train's --max-iters (it clamps the schedule's horizon)")
    p.add_argument("--synthetic", action="store_true", help="scan the synthetic dataset")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def scan(cfg, make_dataset, mode: str, epochs: int, logger, mesh=None) -> dict:
    """{split: (loader, {signature: exemplar samples})} of the modes asked for."""
    from ..data.loader import make_loader

    out = {}
    for split in {"train": ["train"], "eval": ["test"], "both": ["train", "test"]}[mode]:
        loader = make_loader(cfg, make_dataset(cfg, split), split, mesh=mesh)
        t0 = time.perf_counter()
        sigs = loader.scan_signatures(epochs)
        passes = epochs if split == "train" else 1
        logger.info(f"{split}: {len(sigs)} signature(s) over {loader.iters_per_epoch * passes} "
                    f"planned batches ({time.perf_counter() - t0:.1f} s, no decode)")
        for b, t, src, canvas, layout in sorted(sigs):
            logger.info(f"  B={b} T={t} src={src[0]}x{src[1]} out={canvas[0]}x{canvas[1]} {layout}")
        out[split] = (loader, sigs)
    return out


def _measured(mode, sig, device, fn, logger) -> dict:
    """Run fn() (which ends in a read of its results on the host) and log
    its seconds and, on the card, the peak memory."""
    import torch

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    fn()
    rec = {"mode": mode, "signature": sig, "seconds": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None}
    logger.info(f"{mode} {sig}: {rec['seconds']:.2f} s"
                + (f", peak {rec['peak_gb']:.2f} GiB" if cuda else ""))
    return rec


def main(argv=None):
    """The signatures' records, [{"mode", "signature", "seconds",
    "peak_gb"}] (empty with ``--list``)."""
    args = parse_args(argv)
    from ..core.dist import get_rank
    from ..core.logging import setup_logger
    from ..core.mesh import local_batch, mesh_from_config

    device = start(args)
    cfg = load_config(args.config_file, args.opts)
    if not cfg.TPU.DEVICE_PREPROCESS:
        raise SystemExit("precompile targets the raw (TPU.DEVICE_PREPROCESS) input path; "
                         "host-transform shapes key only on (bucket, resolution)")
    logger = setup_logger("stcat_tpu_torch.precompile", cfg.OUTPUT_DIR, rank=get_rank())
    mesh = mesh_from_config(cfg)
    logger.info(f"mesh: {mesh.size} device(s), shape {dict(mesh.shape)}")
    epochs = args.epochs if args.epochs > 0 else cfg.SOLVER.MAX_EPOCH
    scanned = scan(cfg, dataset_builder(args.synthetic), args.mode, epochs, logger, mesh)
    if args.list:
        return []

    import torch

    from ..core.batch import to_device
    from ..eval.engine import eval_inputs
    from ..kernels import _build
    from ..models import build_model
    from ..models.postprocess import postprocess
    from ..train.loop import step_generator
    from ..train.optimizer import make_optimizer
    from ..train.step import (create_train_state, eval_device_split_active, make_eval_forward,
                              make_train_step)

    if device.type == "cuda":
        t0 = time.perf_counter()
        _build.build_all()
        logger.info(f"kernels built into {_build.BUILD_DIR} in {time.perf_counter() - t0:.1f} s")
    model = build_model(cfg, device, seed=cfg.SEED, mesh=mesh)
    records = []
    if "train" in scanned:
        loader, sigs = scanned["train"]
        # the schedule's horizon exactly as train() derives it
        num_training_steps = cfg.SOLVER.MAX_EPOCH * loader.iters_per_epoch
        if args.max_iters is not None:
            num_training_steps = min(num_training_steps, args.max_iters)
        opt = make_optimizer(cfg, model, num_training_steps)
        state = create_train_state(cfg, model, opt)
        step = make_train_step(cfg, model, opt, device=device)
        for sig, samples in sorted(sigs.items()):
            def one():
                batch, targets, _ = loader._make_batch(samples)
                float(step(state, local_batch(batch, mesh), local_batch(targets, mesh),
                           step_generator(cfg, 0, device, mesh.data_index))["loss"])
            records.append(_measured("train", sig, device, one, logger))

    if "test" in scanned:
        loader, sigs = scanned["test"]
        fwd = make_eval_forward(cfg, model)
        split = eval_device_split_active(cfg)
        for sig, samples in sorted(sigs.items()):
            def one():
                batch, _, meta = loader._make_batch(samples)
                batch, sizes, _, _ = eval_inputs(batch, meta, split)
                batch = to_device(local_batch(batch, mesh), device)
                sizes = to_device(sizes, device)
                out = fwd(batch)
                with torch.inference_mode():
                    res = postprocess(out["pred_boxes"], out["pred_sted"], sizes,
                                      out["frame_valid"])
                for t in res:
                    t.cpu()
            records.append(_measured("eval", sig, device, one, logger))
    logger.info(f"ran {len(records)} signature(s) on {device}")
    return records


if __name__ == "__main__":
    main()
