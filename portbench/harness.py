"""What every cell shares: finding a cell's files by name, the port's
configuration, the checks on the device and on loaded modules, and the
result line.

Everything of one configuration, traffic mix, per-layer metric or cell is a
file of its own found by the name ``BENCHMARK.json`` gives it:

    portbench/configs/<config>.json    the configuration as run
    portbench/traffic/<traffic>.json   the mix's parameters (generate.py)
    portbench/metrics/<metric>.py      read(r) -> value or None
    portbench/limits/<cell>.json       the limits that decide ``correct``
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stcat_tpu")


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def config_of(bench: Dict, cell: Dict, root: Path = ROOT) -> Dict:
    return load_json(root / find(bench["configs"], cell["config"], "configuration")["file"])


def traffic_of(cell: Dict) -> Dict:
    return load_json(BENCH / "traffic" / f"{cell['traffic']}.json")


def limits_of(cell: Dict) -> Dict[str, float]:
    return load_json(BENCH / "limits" / f"{cell['name']}.json")["limits"]


def reader(name: str):
    """The module of metrics/<name>.py (names may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(name)}_{abs(hash(name))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: Dict, cell: Dict, kind: str) -> List[Dict]:
    """The cell's end-to-end metrics (kind "end_to_end": those without a
    list of cells, and those that list it) or its per-layer ones (each
    lists its cells)."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"]
                if "workloads" not in m or cell["name"] in m["workloads"]]
    return [m for m in bench["per_layer"] if cell["name"] in m["workloads"]]


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(modules)} & set(FORBIDDEN))


def flatten(tree: Dict, prefix: str = "") -> List[Any]:
    """A nested config dict as KEY VALUE pairs."""
    out: List[Any] = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += flatten(v, f"{prefix}{k}.")
        else:
            out += [f"{prefix}{k}", v]
    return out


def port_config(conf: Dict, *opts):
    """The port's Config: its defaults, the configuration file's keys, then
    ``opts`` (KEY VALUE pairs)."""
    from stcat_tpu_torch.config import default_config, merge_from_list

    return merge_from_list(default_config(), flatten(conf["config"]) + list(opts))


def cache_env(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout; no library
    the port uses may load JAX."""
    cache = root / "portbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


@contextlib.contextmanager
def exact_fp32():
    """float32 products without TF32, for the reference; the flags as they
    were afterwards."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclass
class Check:
    """A number the run compares with its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a kind's run hands back."""
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    readings: Any = None          # the per-layer readers' input
    trace: Any = None             # trace.TraceSummary of the traced part
    notes: Dict[str, Any] = field(default_factory=dict)


def result_line(outcome: Outcome, metrics: List[Dict], device: Dict,
                per_layer: Optional[Dict[str, float]] = None) -> Tuple[str, List[str]]:
    """(the JSON result line, the lines of compared numbers for stderr)."""
    units = {m["name"]: m["unit"] for m in metrics}
    values = per_layer if per_layer is not None else outcome.end_to_end
    out = {
        "correct": bool(outcome.checks) and all(c.ok for c in outcome.checks),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
        "device": device,
    }
    if per_layer is not None and outcome.trace is not None:
        out["breakdown"] = {"device_ops": outcome.trace.device_ops(),
                            "idle_gaps": outcome.trace.idle_gaps()}
    out["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    lines = [f"compared {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}"
             for c in outcome.checks]
    return json.dumps(out, allow_nan=True), lines
