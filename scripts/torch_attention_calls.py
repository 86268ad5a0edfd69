"""Time the port's attention kernels (K1 forward, K2 backward) at the main
path's call sites, on one NVIDIA GPU, for the port in any checkout:

    python scripts/torch_attention_calls.py [--root CHECKOUT] [--reps N]

CHECKOUT is the root of a checkout holding stcat_tpu_torch/ (default: this
one), so two commits can be compared on one card in one session, e.g. an
unpacked `git archive <parent>` beside the working tree, in turns (parent,
change, change, parent). The call sites, their seeded masked inputs and both
timers are this checkout's chip_smoke.py (K1_CASES, K2_CASES, attn_inputs,
time_ms, device_time); only the kernels come from CHECKOUT. Prints the card's
name and power limit, then one line per call site (bf16): event ms per call
(back-to-back calls, host launch cost included, as chip_smoke.py's kernel
line) and device ms per call (kernel durations summed by torch.profiler),
and the sums over one served forward (K1) or one training microbatch (K2).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_attention_calls: CUDA is not available", file=sys.stderr)
        return 2
    # the package under test first: this checkout's chip_smoke.py, loaded by
    # its path, then finds stcat_tpu_torch imported from CHECKOUT
    sys.path.insert(0, os.path.abspath(args.root))
    from stcat_tpu_torch.kernels import attention as kattn
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    print(f"{smoke.nvidia_smi_line()}; port from {os.path.dirname(os.path.dirname(kattn.__file__))}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kernel, cases in (("K1", smoke.K1_CASES), ("K2", smoke.K2_CASES)):
        total_evt = total_dev = 0.0
        for name, bh, sq, sk, dk, dv, per in cases:
            q, k, v, bias, g = smoke.attn_inputs(gen, bh, sq, sk, dk, dv, torch.bfloat16,
                                                 grad=kernel == "K2")
            if kernel == "K1":
                fn = lambda: kattn.flash_attention(q, k, v, bias)  # noqa: E731
            else:
                fn = lambda: kattn.flash_attention_bwd(q, k, v, bias, g)  # noqa: E731
            with torch.no_grad():
                evt, (dev, _) = smoke.time_ms(fn, args.reps), smoke.device_time(fn, args.reps)
            total_evt += per * evt
            total_dev += per * dev
            print(f"  {kernel} {name:30s} BH={bh} Sq={sq} Sk={sk} Dk={dk} Dv={dv}: "
                  f"event {evt:.4f} ms, device {dev:.4f} ms")
        what = "served forward" if kernel == "K1" else "training microbatch"
        print(f"  {kernel} per {what}: event {total_evt:.3f} ms, device {total_dev:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
