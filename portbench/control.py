"""The control of a cell's comparison, and the serving cell's rate sweep.

    python3 portbench/control.py --workload vidstg_r101.train --seeds 1,2,3
    python3 portbench/control.py --workload hcstvg_r101.serve --seeds 1 \\
        --sweep 1,2,3,4 --seconds 20

The control is the plain reference computed with float8 (e4m3) operands in
every product, the next precision below the bfloat16 the recipes state,
put in the port's place: the same comparison, on the cell's own inputs at
its own size, reads each compared number for it. Each limit lies between
the port's readings and the control's. One JSON line per seed. ``--sweep``
offers the serving mix at each rate for ``--seconds`` on one predictor and
prints the latency and the requests still open at each window's end (the
knee is the highest rate whose backlog does not grow).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sweep", default="")
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    harness.cache_env()
    import importlib

    import torch

    from portbench.reference.model import FP8
    from portbench.run import Spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    device = torch.device("cuda", 0)
    kind = importlib.import_module(f"portbench.kinds.{harness.traffic_of(cell)['kind']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        spec = Spec(bench, cell, seed, args.seconds, 0, device, reference_ops=FP8)
        try:
            if args.sweep:
                rows = kind.sweep(spec, [float(r) for r in args.sweep.split(",")], args.seconds)
                print(json.dumps({"seed": seed, "sweep": rows}), flush=True)
            else:
                print(json.dumps({"seed": seed, "control": kind.control(spec)}), flush=True)
        finally:
            spec.work.cleanup()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
