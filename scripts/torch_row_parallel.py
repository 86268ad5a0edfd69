"""The row-parallel Linear's partial product under tensor parallelism two
ways, on one card: operands upcast to fp32 and one fp32 GEMM (CUDA cores,
TF32 off), and ``models/attention.py::_PartialProduct`` (one bf16 GEMM on
the tensor cores with an fp32 result, and bf16 GEMMs in the backward).

    python scripts/torch_row_parallel.py [--iters 20]

Shapes: the full-width VidSTG R101 recipe's row-parallel Linears at model
parallel 2 on phase 9's microbatch (2 clips of 64 frames, 14 x 19 feature
cells per frame): the encoder's attention out_proj (128 of 256 input
columns per rank), its FFN linear2 (1024 of 2048), and RoBERTa's
output.dense (1536 of 3072) on 2 x 32 tokens. Prints per shape the forward
+ backward time of each (CUDA events, median of ``--iters``, host launch
gaps included; and the device time of its kernels, torch.profiler over
``--iters``), the kernels each ran, the memory each keeps for the
backward, the largest difference of the outputs and gradients, and the
card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from stcat_tpu_torch.models.attention import _PartialProduct  # noqa: E402

TOKENS = 2 * 64 * 14 * 19
SHAPES = {  # name: (rows, input columns per rank, outputs)
    "encoder out_proj": (TOKENS, 128, 256),
    "encoder linear2": (TOKENS, 1024, 256),
    "RoBERTa output.dense": (2 * 32, 1536, 768),
}


def upcast(x, w):
    return torch.nn.functional.linear(x.float(), w.float())


def run(fn, x, w, g, iters):
    """(median CUDA-event ms, device ms, the kernels' names) of one forward +
    backward, the bytes the forward keeps for the backward, and the output
    and gradients."""
    def once():
        xi, wi = x.detach().requires_grad_(), w.detach().requires_grad_()
        out = fn(xi, wi)
        out.backward(g)
        return out.detach(), (xi.grad, wi.grad)

    for _ in range(3):
        once()
    xi, wi = x.detach().requires_grad_(), w.detach().requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out = fn(xi, wi)
    kept = torch.cuda.memory_allocated() - base - out.numel() * out.element_size()
    out.backward(g)
    del out, xi, wi
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        once()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    dev_ms, names = cs.device_time(once, reps=iters)
    out, grads = once()
    return sorted(times)[len(times) // 2], dev_ms, names, kept, out, grads


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_row_parallel: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (n, k, m) in SHAPES.items():
        x = torch.randn(n, k, device="cuda", generator=gen).to(torch.bfloat16)
        w = (torch.randn(m, k, device="cuda", generator=gen) * k ** -0.5).to(torch.bfloat16)
        g = torch.randn(n, m, device="cuda", generator=gen).to(torch.bfloat16).float()
        ms_a, dev_a, names_a, kept_a, out_a, grads_a = run(upcast, x, w, g, args.iters)
        ms_b, dev_b, names_b, kept_b, out_b, grads_b = run(_PartialProduct.apply, x, w, g,
                                                           args.iters)
        out_err = ((out_b - out_a).abs().max() / out_a.abs().max()).item()
        grad_err = max(((b.float() - a.float()).abs().max() / a.float().abs().max()).item()
                       for a, b in zip(grads_a, grads_b))
        print(f"{name} [{n} x {k}] @ [{k} x {m}], forward + backward: fp32 upcast {ms_a:.3f} ms "
              f"(events), {dev_a:.3f} ms (device), keeps {kept_a / 2**20:.1f} MiB; bf16 GEMM, "
              f"fp32 out {ms_b:.3f} ms (events), {dev_b:.3f} ms (device), keeps "
              f"{kept_b / 2**20:.1f} MiB; output rel diff {out_err:.3e}, gradients {grad_err:.3e}")
        print(f"  kernels (names cut to 60 characters): fp32 upcast {[k[:60] for k in names_a]}; "
              f"bf16 GEMM {[k[:60] for k in names_b]}")
        if out_b.dtype != torch.float32 or not out_err <= 1e-5 or not grad_err <= 1e-2:
            raise AssertionError(f"{name}: the two partial products disagree")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
