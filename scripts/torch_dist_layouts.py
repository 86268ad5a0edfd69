"""The distribution layouts at full width, each rank on its own card over NCCL
(or every rank on card 0 over gloo), held to one process on card 0.

    python scripts/torch_dist_layouts.py        # NCCL, the layouts whose ranks fit the cards
    python scripts/torch_dist_layouts.py --backend gloo --layouts "model 2"

chip_smoke.py phase 9's recipe, batch and checks: the VidSTG R101 recipe with
every dropout 0, a 4-clip global batch of 64-frame clips, GRAD_ACCUM 2. One
process takes a train step and the EMA-validation forwards (fp32 and bf16),
and takes them again to read its own run-to-run spread; then each layout
spawns its ranks (``core.dist.spawn_ranks``), takes the same step and, under
model or seq parallelism, the forwards, each held to the single process's
(loss and group gradient norms at chip_smoke.py's STEP_TOL, the fp32 forward
at its DIST_FWD_TOL; the bf16 forward is read beside the spread), and over
NCCL one more step under
``torch.cuda.set_sync_debug_mode("error")``. Prints per rank the step time,
peak card memory, K1/K2/K3 launches and each collective's calls and bytes,
and the cards' ``nvidia-smi`` name and power limit. Exits non-zero when a
layout fails a check or a rank fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# name: (ranks, TPU overrides); a data axis of 2 gives each data rank 2 of the
# 4 clips, one per microbatch
LAYOUTS = {
    "data 2": (2, []),
    "model 2": (2, ["TPU.MODEL_PARALLEL", "2"]),
    "seq 2": (2, ["TPU.MESH_SEQ", "2", "TPU.SEQUENCE_PARALLEL", "true"]),
    "model 4": (4, ["TPU.MODEL_PARALLEL", "4"]),
    "seq 4": (4, ["TPU.MESH_SEQ", "4", "TPU.SEQUENCE_PARALLEL", "true"]),
    "data 2 x model 2": (4, ["TPU.MODEL_PARALLEL", "2"]),
    "data 2 x seq 2": (4, ["TPU.MESH_SEQ", "2", "TPU.SEQUENCE_PARALLEL", "true"]),
    "seq 2 x model 2": (4, ["TPU.MODEL_PARALLEL", "2", "TPU.MESH_SEQ", "2",
                            "TPU.SEQUENCE_PARALLEL", "true"]),
}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--backend", choices=["nccl", "gloo"], default="nccl")
    p.add_argument("--layouts", nargs="+", default=None,
                   help="layouts to run (default: every one whose ranks fit: one per card "
                        "over nccl, any over gloo)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_dist_layouts: CUDA is not available", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{cards} card(s): {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    layouts = args.layouts or [n for n, (r, _) in LAYOUTS.items()
                               if args.backend == "gloo" or r <= cards]
    t = time.time()
    cs._build.build_all()
    print(f"kernels built in {time.time() - t:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from stcat_tpu_torch.core.dist import spawn_ranks

    cfg = cs.dist_cfg()
    raw, targets = cs._train_batch(cfg, cs.DIST_TEXTS)
    ref = cs.dist_reference(cfg, raw, targets)

    device = "cuda" if args.backend == "nccl" else "cuda:0"
    for name in layouts:
        ranks, opts = LAYOUTS[name]
        t = time.time()
        got = spawn_ranks(cs.dist_rank, ranks,
                          (cs.dist_cfg(*opts), raw, targets, args.backend == "nccl"),
                          backend=args.backend, device=device, timeout_s=900)
        print(f"{name} over {args.backend}: {time.time() - t:.1f} s with start-up")
        for r in got:
            cs._check_rank(name, r, ref, ref["launches"])
            if args.backend == "nccl":
                cs.check_sync_step(name, r, ref["launches"])
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
