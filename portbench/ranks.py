"""A cell on several devices: one rank per device, joined by the port's
``core/dist.py`` (``spawn_ranks``: torch.distributed at
``tcp://localhost:<free port>``, NCCL on cards, gloo on the CPU). Every
rank runs the cell's kind on its own device and reads its own per-layer
metrics; rank 0 runs the reference over every data rank's clips. The
launching process prints one line from rank 0's results, with the peak of
the fullest device and the device time averaged over the ranks.
"""

from __future__ import annotations

import time
from typing import Dict


def rank_run(rank: int, args: Dict) -> Dict:
    """One rank's run of the cell (``spawn_ranks`` calls it after joining the
    group); returns what the launcher prints from."""
    import torch

    from portbench import harness
    from portbench.run import Spec, run_cell

    bench = harness.load_benchmark()
    cell = args["cell"]
    device = torch.device(args["device"], rank) if args["device"] == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    spec = Spec(bench, cell, args["seed"], args["seconds"], args["trace"], device,
                conf=args.get("conf"), traffic=args.get("traffic"), limits=args.get("limits"),
                t_start=args["t_start"])
    outcome, per_layer = run_cell(spec)
    summary = outcome.trace or getattr(outcome.readings, "trace", None)
    outcome.readings = None
    outcome.trace = summary
    return {"outcome": outcome, "per_layer": per_layer, "setup_s": spec.setup_s}


def launch(args, cell, device: str = "cuda", backend: str = "nccl", extra: Dict = None) -> Dict:
    """Run the cell on ``cell["chips"]`` ranks; returns rank 0's result with
    the memory peak of the fullest rank and the trace's busy and window
    seconds averaged over the ranks."""
    from stcat_tpu_torch.core.dist import spawn_ranks

    payload = {"cell": cell, "seed": args.seed, "seconds": args.seconds,
               "trace": args.trace, "device": device, "t_start": getattr(args, "t_start",
                                                                       time.perf_counter())}
    payload.update(extra or {})
    results = spawn_ranks(rank_run, cell["chips"], (payload,), backend=backend,
                          device=device, timeout_s=3000)
    first = results[0]
    first["outcome"].memory_peak_bytes = max(r["outcome"].memory_peak_bytes for r in results)
    traces = [r["outcome"].trace for r in results if r["outcome"].trace is not None]
    if traces:
        first["busy_s"] = sum(t.busy_s for t in traces) / len(traces)
        first["window_s"] = sum(t.window_s for t in traces) / len(traces)
    return first
