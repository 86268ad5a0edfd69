"""The harness on the CPU: lookup by name, the shape required of
BENCHMARK.json, the no-JAX check, and each cell rehearsed end to end at
tiny widths (the port's plain routes, float32): ``correct`` true on a sound
run, false with the timed path broken underneath (a step that leaves the
state as it was; an answer altered where it is produced), and false for
the float8 control."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.reference.model import FP8
from portbench.run import Spec, run_cell

from tiny import tiny_conf, tiny_traffic

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


# measured, held out of BENCHMARK.json (PERF.md section 7); rehearsed here
HELD = {c["name"]: c for c in (
    {"name": "vidstg_r101.train", "config": "stcat_r101_vidstg", "traffic": "vidstg_train",
     "chips": 1},
    {"name": "vidstg_r101.eval", "config": "stcat_r101_vidstg", "traffic": "vidstg_test",
     "chips": 1})}


def cell_of(bench, name):
    return HELD[name] if name in HELD else harness.find(bench["workloads"], name, "workload")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_every_cell_finds_its_files_by_name(bench):
    for cell in bench["workloads"]:
        conf = harness.config_of(bench, cell)
        assert conf["config"]["MODEL"]["STCAT"]["HIDDEN"] == 256
        traffic = harness.traffic_of(cell)
        assert traffic["kind"] in ("train", "eval", "serve")
        assert (harness.BENCH / "kinds" / f"{traffic['kind']}.py").exists()
        assert set(harness.limits_of(cell)) >= {"box_px", "span_gap"} or set(
            harness.limits_of(cell)) == {"loss_rel", "grad_leaf", "change_leaf", "sample_off",
                                         "box_target"}
        for m in harness.metrics_of(bench, cell, "per_layer"):
            assert callable(harness.reader(m["name"]).read)
        e2e = {m["name"] for m in harness.metrics_of(bench, cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
    with pytest.raises(KeyError):
        harness.find(bench["workloads"], "no.such.cell", "workload")


@pytest.mark.parametrize("name", ["vidstg_r101.train", "vidstg_r101.eval"])
def test_each_held_cell_keeps_its_files(name):
    """A cell held out of BENCHMARK.json keeps its configuration, mix,
    limits and readers, so a later PR adds it back as an entry alone."""
    cell = HELD[name]
    assert (harness.BENCH / "configs" / f"{cell['config']}.json").exists()
    kind = harness.traffic_of(cell)["kind"]
    assert name.endswith(f".{kind}") and set(harness.limits_of(cell))
    readers = sorted((harness.BENCH / "metrics").glob(f"*.{kind}.py"))
    assert len(readers) >= 3
    for path in readers:
        assert callable(harness.reader(path.name[:-3]).read)


def test_benchmark_json_keeps_its_required_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024


def test_forbidden_modules_compare_whole_top_level_names():
    found = harness.forbidden_modules({"stcat_tpu_torch.models": 1, "jaxtyping": 1,
                                       "numpy": 1})
    assert found == []
    assert harness.forbidden_modules({"stcat_tpu.models.stcat": 1, "jax.numpy": 1,
                                      "flax": 1}) == ["flax", "jax", "stcat_tpu"]


def test_the_measuring_process_loads_no_jax():
    """Every module the harness and its kinds import, and the port's modules
    they call, in a fresh process: none is JAX or the JAX package."""
    code = ("import sys; sys.path.insert(0, %r); import portbench.run, portbench.control, "
            "portbench.ranks, portbench.kinds.train, portbench.kinds.serve, "
            "portbench.kinds.eval, stcat_tpu_torch.serve, stcat_tpu_torch.train.loop, "
            "stcat_tpu_torch.eval.engine, stcat_tpu_torch.data.datasets; "
            "from portbench import harness; print(harness.forbidden_modules())") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"), "--workload",
                          "hcstvg_r101.serve", "--seed", str(2 ** 31 + 7), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert out.returncode != 0
    assert not out.stdout.strip()


def tiny_spec(bench, name, seconds=3.0, **kw):
    cell = cell_of(bench, name)
    return Spec(bench, cell, 2 ** 31 + 11, seconds, 0, torch.device("cpu"),
                conf=tiny_conf(cell["config"]), traffic=tiny_traffic(cell["traffic"]), **kw)


def correct(outcome) -> bool:
    return bool(outcome.checks) and all(c.ok for c in outcome.checks)


@pytest.mark.parametrize("name", ["vidstg_r101.train", "hcstvg_r101.serve", "vidstg_r101.eval"])
def test_a_tiny_rehearsal_of_each_cell_is_correct(bench, name):
    outcome, _ = run_cell(tiny_spec(bench, name))
    assert correct(outcome), outcome.checks
    assert outcome.attempted > 0 and outcome.failed == 0


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(bench, monkeypatch):
    from stcat_tpu_torch.train import optimizer

    monkeypatch.setattr(optimizer.GroupedOptimizer, "step", lambda self: None)
    outcome, _ = run_cell(tiny_spec(bench, "vidstg_r101.train"))
    assert not correct(outcome)
    assert {c.name for c in outcome.checks if not c.ok} >= {"change_leaf"}


def _shifted_frames(fn):
    def shifted(cfg, split, item, rng):
        out = fn(cfg, split, item, rng)
        out["frame_ids"] = [out["frame_ids"][1]] + list(out["frame_ids"][1:])
        return out
    return shifted


def _moved_boxes(fn):
    return lambda boxes, hw: fn(boxes, hw) + 0.01


@pytest.mark.parametrize("name,patch", [("make_vidstg_input_clip", _shifted_frames),
                                        ("boxes_to_normalized_cxcywh", _moved_boxes)])
def test_a_training_target_altered_in_the_loader_is_not_correct(bench, monkeypatch, name, patch):
    """The loader samples the wrong frames, or moves the box targets: the
    reference works both out from the corpus and the run is not correct."""
    from stcat_tpu_torch.data import datasets

    monkeypatch.setattr(datasets, name, patch(getattr(datasets, name)))
    outcome, _ = run_cell(tiny_spec(bench, "vidstg_r101.train"))
    assert not correct(outcome)
    assert {c.name for c in outcome.checks if not c.ok} & {"sample_off", "box_target"}


def _shift_span(fn):
    def shifted(*args, **kw):
        bbox, temp = fn(*args, **kw)
        for v in temp.values():
            v["sted"] = [v["sted"][0] + 1, v["sted"][1] + 1]
        return bbox, temp
    return shifted


@pytest.mark.parametrize("name,module", [("hcstvg_r101.serve", "stcat_tpu_torch.serve"),
                                         ("vidstg_r101.eval", "stcat_tpu_torch.eval.engine")])
def test_an_answer_altered_where_it_is_produced_is_not_correct(bench, monkeypatch, name, module):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, "merge_two_streams", _shift_span(mod.merge_two_streams))
    outcome, _ = run_cell(tiny_spec(bench, name))
    assert not correct(outcome)


@pytest.mark.parametrize("name", ["vidstg_r101.train", "hcstvg_r101.serve", "vidstg_r101.eval"])
def test_the_float8_control_is_not_correct(bench, name):
    import importlib

    spec = tiny_spec(bench, name, reference_ops=FP8)
    kind = importlib.import_module(f"portbench.kinds.{spec.traffic['kind']}")
    readings = kind.control(spec)
    assert any(readings[k] > spec.limits[k] for k in readings if k in spec.limits), readings


def test_the_rank_launcher_over_gloo_with_two_ranks(bench):
    from types import SimpleNamespace

    from portbench import ranks

    cell = dict(HELD["vidstg_r101.train"], chips=2)
    args = SimpleNamespace(seed=2 ** 31 + 13, seconds=3.0, trace=0)
    res = ranks.launch(args, cell, device="cpu", backend="gloo", extra={
        "conf": tiny_conf(cell["config"]), "traffic": tiny_traffic(cell["traffic"]),
        "limits": harness.limits_of(cell)})
    assert correct(res["outcome"]), res["outcome"].checks
    assert res["outcome"].end_to_end["train_clips_per_s"] > 0
