"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload vidstg_r101.train --seed 12345 \\
        --seconds 30 --trace 0

It finds the cell in BENCHMARK.json, makes its inputs and weights from the
seed, sets up the port as the cell's kind runs it (``kinds/<kind>.py``;
the traffic file names the kind), measures for ``--seconds``, checks what
the timed path produced against the plain reference, and prints one JSON
line last on standard output: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1`` (the profiler then
covers the window's first TRACE_SECONDS). Each number compared with its
limit is printed last on standard error too. It exits with an error and
prints no result when no CUDA device is there, when the cell asks for more
devices than there are, or when JAX or the JAX package was loaded.

A cell with ``chips`` > 1 runs one rank per device under torch.distributed
(NCCL, the port's ``core/dist.py`` environment); rank 0 prints.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

TRACE_SECONDS = 4.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Marks:
    """Where the traced part of the window ends: the profiler runs from the
    window's start for TRACE_SECONDS (then the device is synchronized), and
    the readers see how much work each part held."""

    def __init__(self, tracer, t0: float, seconds: float):
        self.tracer, self.t0, self.seconds = tracer, t0, seconds
        self.traced_until = None  # (work units, time) at the trace's end
        if tracer is not None:
            tracer.start()

    def tick(self, done: int) -> None:
        if self.tracer is not None and self.traced_until is None and (
                time.perf_counter() - self.t0 >= self.seconds):
            self.tracer.stop()
            self.traced_until = (done, time.perf_counter())

    def close(self, done: int, t1: float) -> None:
        if self.tracer is not None and self.traced_until is None:
            self.tracer.stop()
            self.traced_until = (done, t1)


class Spec:
    """One run's inputs and the hooks a kind calls back into."""

    def __init__(self, bench, cell, seed, seconds, trace, device, reference_ops=None,
                 limits=None, conf=None, traffic=None, t_start=None):
        from portbench.reference.model import FP32, arch_of
        from portbench.trace import Spans

        self.bench, self.cell, self.seed, self.seconds = bench, cell, seed, seconds
        self.trace, self.device = bool(trace), device
        self.conf = conf if conf is not None else harness.config_of(bench, cell)
        arch_of(self.conf["config"])  # a key the reference does not model stops the run here
        self.traffic = traffic if traffic is not None else harness.traffic_of(cell)
        self.limits = limits if limits is not None else harness.limits_of(cell)
        self.reference_ops = reference_ops or FP32
        self.spans = Spans()
        self.tracer = None
        # inputs written for this run (a corpus, a data cache), removed after it
        self.work = tempfile.TemporaryDirectory(prefix="portbench-")
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.setup_s = None

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self, t0: float) -> None:
        self.setup_s = t0 - self.t_start

    def start_trace(self, t0: float) -> Marks:
        if self.trace:
            from portbench.trace import Trace

            self.tracer = Trace(self.spans, cuda=self.device.type == "cuda")
        return Marks(self.tracer, t0, min(TRACE_SECONDS, self.seconds))

    def readings(self, **kw) -> SimpleNamespace:
        summary = self.tracer.reduce() if self.tracer is not None else None
        return SimpleNamespace(spans=self.spans, trace=summary, cell=self.cell,
                               conf=self.conf, traffic=self.traffic, **kw)


def run_cell(spec: Spec):
    """(outcome, per-layer values or None) of one run of a cell."""
    import importlib

    kind = importlib.import_module(f"portbench.kinds.{spec.traffic['kind']}")
    try:
        outcome = kind.run(spec)
    finally:
        spec.work.cleanup()
    per_layer = None
    if spec.trace:
        per_layer = {}
        for m in harness.metrics_of(spec.bench, spec.cell, "per_layer"):
            value = harness.reader(m["name"]).read(outcome.readings)
            if value is not None:
                per_layer[m["name"]] = value
    return outcome, per_layer


def main(argv=None) -> int:
    args = parse_args(argv)
    harness.cache_env()
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    if cell["chips"] > 1:
        from portbench import ranks

        args.t_start = T_START
        res = ranks.launch(args, cell)
        return emit(res["outcome"], res["per_layer"], cell, bench, res["setup_s"],
                    (res["busy_s"], res["window_s"]) if "busy_s" in res else None)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    spec = Spec(bench, cell, args.seed, args.seconds, args.trace, device, t_start=T_START)
    outcome, per_layer = run_cell(spec)
    return emit(outcome, per_layer, cell, bench, spec.setup_s)


def emit(outcome, per_layer, cell, bench, setup_s, busy_window=None) -> int:
    """Print the compared numbers on stderr and the result line; 3 (and no
    result) when a forbidden module was loaded."""
    import torch

    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if per_layer is None:
        outcome.end_to_end["setup_s"] = setup_s
        outcome.end_to_end["peak_mem_gib"] = outcome.memory_peak_bytes / 2 ** 30
        wanted = {m["name"] for m in harness.metrics_of(bench, cell, "end_to_end")}
        outcome.end_to_end = {k: v for k, v in outcome.end_to_end.items() if k in wanted}
        metrics = harness.metrics_of(bench, cell, "end_to_end")
    else:
        summary = outcome.trace or getattr(outcome.readings, "trace", None)
        outcome.trace = summary
        if busy_window is None and summary is not None:
            busy_window = (summary.busy_s, summary.window_s)
        if busy_window is not None:
            device["busy_s"], device["window_s"] = busy_window
        metrics = harness.metrics_of(bench, cell, "per_layer")
    line, compared = harness.result_line(outcome, metrics, device, per_layer)
    outcome.notes["card_after_window"] = _card_state()
    for k, v in outcome.notes.items():
        print(f"note {k}: {v}", file=sys.stderr)
    for text in compared:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


def _card_state() -> str:
    """The card's SM clock, power draw and limit, and temperature, read once
    the window has closed (the card's power limit decides its speed)."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
                               "temperature.gpu", "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"


if __name__ == "__main__":
    sys.exit(main())
