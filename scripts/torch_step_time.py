"""Time the port's full-width train step and evaluation pass on one NVIDIA
GPU, for the port in any checkout:

    python scripts/torch_step_time.py [--root CHECKOUT] [--steps N] [--passes N]

CHECKOUT is the root of a checkout holding stcat_tpu_torch/ (default: this
one), so two commits can be compared on one card in one session, e.g. an
unpacked `git archive <parent>` beside the working tree, in turns (parent,
change, change, parent). The workload is this checkout's chip_smoke.py's:
the VidSTG R101 recipe at full width with seeded weights, STCAT.DROPOUT 0,
GRAD_ACCUM 2 of two seeded 64-frame clips (recipe_cfg, _train_batch), and
for evaluation its loop phase's synthetic test split (4 items of 128 frames
at 320x240, rendered, BATCH_SIZE 2). Only the package comes from CHECKOUT.
Prints the card's name and power limit, then

  * read each step: N steps, each from its start to its losses read on the
    host (a hand-fed step);
  * run ahead: N steps queued back to back with one read after the last (the
    training loop between two LOG_PERIOD reads), seconds per step;
  * one step under torch.profiler: the device's kernel time and busy share;
  * do_eval: N passes over the test split, seconds per pass;
and beside the step and eval timings the card's mean SM clock (MHz) and
power draw (W), sampled by nvidia-smi every 100 ms while they ran.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class CardSampler:
    """nvidia-smi sampling the SM clock and power draw every 100 ms while
    the block runs; ``summary()`` gives their means."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = [line.split(",") for line in out.splitlines() if line.count(",") == 1]
        self.samples = [(float(c), float(w)) for c, w in rows]

    def summary(self) -> str:
        if not self.samples:
            return "clock and power not sampled"
        clocks, watts = zip(*self.samples)
        return (f"SM clock {statistics.mean(clocks):.0f} MHz, power {statistics.mean(watts):.0f} W "
                f"({len(self.samples)} samples)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_time: CUDA is not available", file=sys.stderr)
        return 2
    # the package under test first: this checkout's chip_smoke.py, loaded by
    # its path, then finds stcat_tpu_torch imported from CHECKOUT
    sys.path.insert(0, os.path.abspath(args.root))
    import stcat_tpu_torch
    from stcat_tpu_torch.core.batch import to_device
    from stcat_tpu_torch.data.loader import make_loader
    from stcat_tpu_torch.data.synthetic import SyntheticDataset, write_synthetic_cache
    from stcat_tpu_torch.eval.engine import do_eval
    from stcat_tpu_torch.eval.evaluator import build_evaluator
    from stcat_tpu_torch.models import build_model
    from stcat_tpu_torch.train.optimizer import make_optimizer
    from stcat_tpu_torch.train.step import create_train_state, make_train_step
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    print(f"{smoke.nvidia_smi_line()}; port from {os.path.dirname(stcat_tpu_torch.__file__)}")
    cfg = smoke.recipe_cfg("MODEL.STCAT.DROPOUT", "0.0", "TPU.GRAD_ACCUM", str(smoke.ACCUM),
                           "SOLVER.WARMUP_PROP", "0.0")
    model = build_model(cfg, "cuda", seed=0)
    opt = make_optimizer(cfg, model, num_training_steps=1000)
    state = create_train_state(cfg, model, opt)
    step = make_train_step(cfg, model, opt)
    raw, targets = smoke._train_batch(cfg)
    raw, targets = to_device(raw, "cuda"), to_device(targets, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):  # the optimizer's state and cuDNN's first calls
        step(state, raw, targets, gen)["loss"].item()

    read_each = []
    with CardSampler() as card:
        for _ in range(args.steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(state, raw, targets, gen)["loss"].item()
            read_each.append(time.perf_counter() - t)
    print(f"  read each step (s): {', '.join(f'{x:.4f}' for x in read_each)}; median "
          f"{statistics.median(read_each):.4f}; {card.summary()}")
    with CardSampler() as card:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(args.steps):
            losses = step(state, raw, targets, gen)
        losses["loss"].item()
        ahead = (time.perf_counter() - t) / args.steps
    print(f"  run ahead: {args.steps} steps, one read after the last: {ahead:.4f} s per step; "
          f"{card.summary()}")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(state, raw, targets, gen)["loss"].item()
        wall = time.perf_counter() - t
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    print(f"  profiled step: wall {wall:.4f} s, device kernels {device:.4f} s, busy "
          f"{100 * device / wall:.1f}%")
    del state, opt, step

    with tempfile.TemporaryDirectory(prefix="torch_step_time_") as tmp:
        write_synthetic_cache(tmp, "VidSTG", "test", n_items=4, n_frames=128, width=320,
                              height=240, seed=0)
        ecfg = smoke.recipe_cfg("SOLVER.BATCH_SIZE", "2", "TPU.FRAME_BUCKETS", "[64,128]",
                                "DATA_DIR", tmp, "OUTPUT_DIR", "")
        passes = []
        with CardSampler() as card:
            for i in range(args.passes + 1):
                loader = make_loader(ecfg, SyntheticDataset(ecfg, "test"), "test")
                t = time.perf_counter()
                do_eval(ecfg, model, loader, build_evaluator(ecfg, None, "test"))
                if i:  # the first pass warms the loader and cuDNN
                    passes.append(time.perf_counter() - t)
    print(f"  do_eval over 2 stacked batches (s per pass): "
          f"{', '.join(f'{x:.4f}' for x in passes)}; median {statistics.median(passes):.4f}; "
          f"{card.summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
