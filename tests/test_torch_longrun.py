"""The port's long-run record (scripts/torch_longrun.sh) on the CPU.

A tiny ``train.loop.train`` is stopped by SIGTERM and resumed, as the long
run is, and scripts/longrun_summary.py reads what it wrote: the metric rows
must carry every field the summariser reads. The script itself must name
only the port's entry points.
"""

import ast
import importlib.util
import json
import math
import os
import re
import signal
import subprocess

import torch_learning as tl
from stcat_tpu_torch.config import default_config, merge_from_list
from stcat_tpu_torch.core.logging import setup_logger
from stcat_tpu_torch.data.synthetic import make_synthetic_dataset
from stcat_tpu_torch.train import loop as ploop
from stcat_tpu_torch.train.checkpoint import Checkpointer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "torch_longrun.sh")
_SPEC = importlib.util.spec_from_file_location(
    "longrun_summary", os.path.join(ROOT, "scripts", "longrun_summary.py"))
longrun_summary = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(longrun_summary)

ITERS, CUT = 6, 3


def _interrupt_at(monkeypatch, at: int):
    """SIGTERM to this process right after the loop's step ``at``."""
    real = ploop.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def wrapped(state, *args):
            out = step(state, *args)
            if state.step == at:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapped

    monkeypatch.setattr(ploop, "make_train_step", make)


def test_summary_reads_a_cut_and_resumed_port_run(tmp_path, monkeypatch):
    out = str(tmp_path / "out")
    cfg = merge_from_list(default_config(), tl.TINY_OPTS + [
        "INPUT.RESOLUTION", 64, "INPUT.TRAIN_SAMPLE_NUM", 4, "INPUT.MAX_QUERY_LEN", 12,
        "TPU.FRAME_BUCKETS", "[4,8]", "DATALOADER.NUM_WORKERS", 0,
        "SOLVER.CHECKPOINT_PERIOD", 2, "DATA_DIR", str(tmp_path / "data"), "OUTPUT_DIR", out])
    logger = setup_logger(f"longrun-{tmp_path.name}", out)

    def builder(c, split):
        return make_synthetic_dataset(c, split, n_items=2, n_frames=8)

    monkeypatch.setattr(ploop, "LOG_PERIOD", 1)  # a row per iteration
    with monkeypatch.context() as m:
        _interrupt_at(m, CUT)
        _, it = ploop.train(cfg, builder, logger=logger, max_iters=ITERS, device="cpu")
    assert it == CUT and Checkpointer(out).last_step() == CUT
    _, it = ploop.train(cfg, builder, logger=logger, max_iters=ITERS, device="cpu")
    assert it == ITERS

    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == list(range(1, ITERS + 1))
    for r in rows:
        assert {"loss", "step_time", "data_time"} <= set(r), r
        assert not {"hbm_in_use_gb", "hbm_peak_gb"} & set(r), r  # the card's memory only

    s = longrun_summary.summarize(out, str(tmp_path / "artifact"))
    assert s["resume_observed"] is True and s["resume_iteration"] == CUT
    assert s["total_logged_steps"] == ITERS and s["log_rows"] == ITERS
    assert s["loss_curve"] and all(math.isfinite(p["loss"]) for p in s["loss_curve"])
    assert math.isfinite(s["loss_first"]) and math.isfinite(s["loss_last"])
    assert s["step_time_median_first_quarter_s"] > 0 and s["step_time_median_last_quarter_s"] > 0
    assert s["step_time_drift_frac"] is not None and s["data_wait_frac_median"] is not None
    for key in ("hbm_in_use_gb_first_quarter", "hbm_in_use_gb_last_quarter", "hbm_drift_frac",
                "hbm_peak_gb"):
        assert s[key] is None, key
    assert os.path.exists(tmp_path / "artifact" / "summary.json")


def test_longrun_script_names_only_the_ports_entry_points():
    """Every module the script runs or imports is the port's, and the one
    script it calls, the summariser, imports no JAX and nothing of the JAX
    package; the script parses."""
    with open(SCRIPT) as f:
        text = f.read()
    assert not re.search(r"stcat_tpu(?!_torch)", text)
    modules = re.findall(r"python -m (\S+)", text) + re.findall(r"from (\S+) import", text)
    assert modules and all(m.startswith("stcat_tpu_torch.") for m in modules), modules
    assert re.findall(r"python (scripts/\S+)", text) == ["scripts/longrun_summary.py"]
    with open(os.path.join(ROOT, "scripts", "longrun_summary.py")) as f:
        tree = ast.parse(f.read())
    imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert not imported & {"jax", "jaxlib", "flax", "stcat_tpu"}, imported
    subprocess.run(["bash", "-n", SCRIPT], check=True)
