"""The port's spans and counters (``stcat_tpu_torch/core/trace.py``) on the CPU.

Off, a span is one shared object that records nothing and the launch
counters still count. On, the serving path records each request's way through
``MicroBatcher`` and ``predict_batch`` (the tiny predictor of
tests/test_torch_serve.py, with fresh weights: no JAX here), ``do_eval``
and the training loop and step record their phases in order, the loop's
``data_time`` and ``step_time`` are its spans' times, spans of concurrent
threads keep their own parents, and the clock anchors put a span where
``torch.profiler`` puts the same block.
"""

import json
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from stcat_tpu_torch import serve
from stcat_tpu_torch.config import default_config, merge_from_list
from stcat_tpu_torch.core import trace
from stcat_tpu_torch.data.loader import Loader
from stcat_tpu_torch.data.synthetic import make_synthetic_dataset
from stcat_tpu_torch.eval.engine import do_eval
from stcat_tpu_torch.eval.evaluator import build_evaluator
from stcat_tpu_torch.kernels import attention as pka
from stcat_tpu_torch.kernels import bottleneck as pkb
from stcat_tpu_torch.models import build_model
from stcat_tpu_torch.serve import GroundingPredictor, MicroBatcher
from stcat_tpu_torch.train import loop as ploop

# tests/helpers.py::tiny_cfg's sizes, in the port's config
TINY = ["MODEL.VISION_BACKBONE.NAME", "resnet50", "MODEL.VISION_BACKBONE.DEPTHS", "[1,1,1,1]",
        "MODEL.STCAT.ENC_LAYERS", 1, "MODEL.STCAT.DEC_LAYERS", 2, "MODEL.STCAT.HIDDEN", 64,
        "MODEL.STCAT.HEADS", 4, "MODEL.STCAT.FFN_DIM", 128, "INPUT.MAX_VIDEO_LEN", 32,
        "MODEL.TEXT_MODEL.VOCAB_SIZE", 128, "MODEL.TEXT_MODEL.HIDDEN", 32,
        "MODEL.TEXT_MODEL.LAYERS", 1, "MODEL.TEXT_MODEL.HEADS", 2,
        "MODEL.TEXT_MODEL.INTERMEDIATE", 64, "MODEL.TEXT_MODEL.MAX_POS", 64,
        "TPU.COMPUTE_DTYPE", "float32", "TPU.REMAT_BACKBONE", "false",
        "MODEL.STCAT.DROPOUT", 0.0, "MODEL.STCAT.HEAD_DROPOUT", 0.0,
        "MODEL.TEXT_MODEL.DROPOUT", 0.0, "INPUT.RESOLUTION", 64, "INPUT.MAX_QUERY_LEN", 8,
        "TPU.FRAME_BUCKETS", "[8]"]
# tests/test_torch_loop.py's loop options
LOOP = ["INPUT.TRAIN_SAMPLE_NUM", 8, "INPUT.AUG_SCALE", "false", "INPUT.AUG_CROP", "false",
        "MODEL.EMA_DECAY", 0.5, "SOLVER.BATCH_SIZE", 2, "SOLVER.MAX_EPOCH", 2,
        "SOLVER.CHECKPOINT_PERIOD", 100, "SOLVER.TO_VAL", "false", "SOLVER.WARMUP_PROP", 0.0,
        "DATALOADER.NUM_WORKERS", 1]
BATCH_CHILDREN = ["serve.prepare", "serve.h2d", "serve.forward", "serve.postprocess",
                  "serve.readback", "serve.merge"]


def tiny(*opts):
    return merge_from_list(default_config(), TINY + list(opts))


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.fixture(scope="module")
def predictor():
    cfg = tiny()
    state = build_model(cfg, device="cpu", seed=0).state_dict()
    return GroundingPredictor(cfg, state_dict=state, max_batch=2, device="cpu")


def _clip(t=12, seed=0):
    return np.random.RandomState(seed).randint(0, 255, size=(t, 48, 64, 3), dtype=np.uint8)


def by_name(spans, name):
    return [s for s in spans if s["name"] == name]


# --------------------------------------------------------------------------
# the recorder itself
# --------------------------------------------------------------------------

def test_off_records_nothing_allocates_nothing_and_counters_count():
    assert not trace.enabled()
    counter = trace.Counter("test.off_counter")

    def calls(n):
        for _ in range(n):
            with trace.span("x") as s:
                counter.add()
            s.note(k=1)
            trace.record("y", 0, 1, request=3)

    tracemalloc.start()
    try:
        calls(100)  # the interpreter's one-time caches
        before = tracemalloc.take_snapshot()
        calls(9_900)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = sum(d.size_diff for d in after.compare_to(before, "filename")
                if d.traceback[0].filename == trace.__file__)
    assert grown < 9_900  # under a byte a call: nothing is kept per call
    assert trace.span("y") is trace.span("z", a=1) is trace.OFF and trace.OFF.start is None
    out = trace.drain()
    assert out["spans"] == []
    assert out["counters"]["test.off_counter"] == counter.count == 10_000
    counter.reset()
    assert trace.drain()["counters"]["test.off_counter"] == 0
    with pytest.raises(ValueError, match="exists already"):
        trace.Counter("test.off_counter")


def test_launch_counters_are_registered_under_their_names():
    counters = trace.drain()["counters"]
    assert {"k1.launches", "k2.launches", "k3.launches"} <= set(counters)
    assert counters["k1.launches"] == pka.LAUNCHES.count
    assert counters["k2.launches"] == pka.BWD_LAUNCHES.count
    assert counters["k3.launches"] == pkb.LAUNCHES.count


def test_on_records_name_times_thread_parent_and_attrs_then_drain_clears():
    trace.enable()
    with trace.span("outer", a=1) as outer:
        with trace.span("inner") as inner:
            inner.note(b=2)
    trace.record("given", 5, 9, c=3)
    out = trace.drain()
    assert [s["name"] for s in out["spans"]] == ["inner", "outer", "given"]
    got = {s["name"]: s for s in out["spans"]}
    assert got["outer"]["parent"] is None and got["inner"]["parent"] == got["outer"]["id"]
    assert got["outer"]["attrs"] == {"a": 1} and got["inner"]["attrs"] == {"b": 2}
    assert got["given"] == {**got["given"], "start_ns": 5, "end_ns": 9, "parent": None,
                            "attrs": {"c": 3}}
    assert got["outer"]["start_ns"] == outer.start <= inner.start < inner.end <= outer.end
    assert got["inner"]["thread"] == threading.get_ident()
    assert got["inner"]["thread_name"] == threading.current_thread().name
    (w0, p0), (w1, p1) = out["anchors"]
    assert p0 <= outer.start and p1 >= outer.end and w1 >= w0
    assert abs((w1 - p1) - (w0 - p0)) < 50_000_000  # the wall clock's drift
    assert trace.drain()["spans"] == []


def test_spans_of_concurrent_threads_keep_their_own_parents():
    """32 threads nest spans two deep while the interpreter switches threads
    every microsecond: every inner span's parent is its own thread's outer
    span, and no record is lost."""
    n_threads, n_spans = 32, 100
    trace.enable()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait(timeout=30)
        for j in range(n_spans):
            with trace.span("outer", thread=i, j=j):
                with trace.span("inner", thread=i, j=j):
                    pass

    threads = [threading.Thread(target=work, args=(i,), name=f"t{i}") for i in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    spans = trace.drain()["spans"]
    assert len(spans) == 2 * n_threads * n_spans
    outer = {s["id"]: s for s in by_name(spans, "outer")}
    for s in by_name(spans, "inner"):
        parent = outer[s["parent"]]
        assert parent["attrs"] == s["attrs"] and parent["thread"] == s["thread"]
        assert s["thread_name"] == f"t{s['attrs']['thread']}"


def test_anchors_put_a_span_where_the_profiler_puts_the_same_block():
    """Under torch.profiler's CPU activity a port span and a
    record_function over one block, the span mapped onto the profiler's
    wall clock through the anchors, agree within 1 ms at both ends."""
    from torch.profiler import ProfilerActivity, profile, record_function

    trace.enable()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with record_function("warm"):
        pass
    with trace.span("block"), record_function("block"):
        time.sleep(0.02)
    prof.stop()
    out = trace.drain()
    (ours,) = by_name(out["spans"], "block")
    (theirs,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "block"]
    assert abs(trace.to_wall(ours["start_ns"], out["anchors"]) - theirs.start_ns()) < 1_000_000
    assert abs(trace.to_wall(ours["end_ns"], out["anchors"])
               - (theirs.start_ns() + theirs.duration_ns())) < 1_000_000


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_micro_batcher_records_each_requests_path(predictor):
    """A group of 2 and a group of 1 through MicroBatcher: each request's
    serve.queued carries its id and ends where its group's serve.dispatch
    begins; serve.batch nests under serve.dispatch and its six children
    under it, in order, on the dispatcher thread, and carries the real and
    padded lanes."""
    trace.enable()
    with MicroBatcher(predictor, max_wait_ms=500) as mb:
        pair = [mb.submit(_clip(seed=k), f"a person {k}") for k in range(2)]
        for f in pair:
            f.result(timeout=120)
        mb.submit(_clip(seed=2), "a person alone").result(timeout=120)
    spans = trace.drain()["spans"]
    dispatches = by_name(spans, "serve.dispatch")
    assert [d["attrs"]["requests"] for d in dispatches] == [[0, 1], [2]]
    assert len(by_name(spans, "serve.group")) == 2
    queued = by_name(spans, "serve.queued")
    assert sorted(q["attrs"]["request"] for q in queued) == [0, 1, 2]
    for q in queued:
        (d,) = [d for d in dispatches if q["attrs"]["request"] in d["attrs"]["requests"]]
        assert q["end_ns"] == d["start_ns"] and q["start_ns"] <= d["start_ns"]
    batches = by_name(spans, "serve.batch")
    assert [(b["attrs"]["real"], b["attrs"]["lanes"]) for b in batches] == [(2, 2), (1, 2)]
    for d, b in zip(dispatches, batches):
        assert b["parent"] == d["id"]
        children = sorted((s for s in spans if s["parent"] == b["id"]),
                          key=lambda s: s["start_ns"])
        assert [s["name"] for s in children] == BATCH_CHILDREN
        assert b["start_ns"] <= children[0]["start_ns"] and children[-1]["end_ns"] <= b["end_ns"]
        for s in [d, b, *children]:
            assert s["thread_name"] == serve.DISPATCHER


def test_each_submitted_request_is_staged_on_the_staging_thread(predictor):
    """One serve.stage per submitted request, carrying its id, on the
    staging thread, ending before its group's serve.prepare ends; a direct
    call records none."""
    trace.enable()
    with MicroBatcher(predictor, max_wait_ms=500) as mb:
        for f in [mb.submit(_clip(seed=k), f"a person {k}") for k in range(3)]:
            f.result(timeout=120)
    predictor.predict(_clip(), "a direct call")
    spans = trace.drain()["spans"]
    stages = by_name(spans, "serve.stage")
    assert sorted(s["attrs"]["request"] for s in stages) == [0, 1, 2]
    assert all(s["thread_name"].startswith(serve.STAGER) and s["parent"] is None
               for s in stages)
    prepares = by_name(spans, "serve.prepare")
    assert len(prepares) == 3  # two groups, then the direct call
    for d in by_name(spans, "serve.dispatch"):
        (b,) = [b for b in by_name(spans, "serve.batch") if b["parent"] == d["id"]]
        (p,) = [p for p in prepares if p["parent"] == b["id"]]
        for s in stages:
            if s["attrs"]["request"] in d["attrs"]["requests"]:
                assert s["end_ns"] <= p["end_ns"]


def test_a_failed_group_still_records_its_dispatch_and_queued_spans(predictor):
    """A group whose prep raises: both callers get the error, its
    serve.dispatch and each request's serve.queued are recorded, and its
    serve.batch closes with serve.prepare as its only child."""
    trace.enable()
    with MicroBatcher(predictor, max_wait_ms=2000) as mb:
        futs = [mb.submit(_clip().astype(np.float32), "bad frames"), mb.submit(_clip(), "ok")]
        for f in futs:
            with pytest.raises(ValueError, match="uint8"):
                f.result(timeout=120)
    spans = trace.drain()["spans"]
    (d,) = by_name(spans, "serve.dispatch")
    assert d["attrs"]["requests"] == [0, 1]
    assert sorted(q["attrs"]["request"] for q in by_name(spans, "serve.queued")) == [0, 1]
    (b,) = by_name(spans, "serve.batch")
    assert b["parent"] == d["id"] and b["attrs"] == {}
    assert [s["name"] for s in spans if s["parent"] == b["id"]] == ["serve.prepare"]


def test_predict_batch_alone_records_a_batch_without_parent(predictor):
    trace.enable()
    predictor.predict(_clip(), "a person waves")
    spans = trace.drain()["spans"]
    (batch,) = by_name(spans, "serve.batch")
    assert batch["parent"] is None and batch["attrs"] == {"real": 1, "lanes": 2}
    assert sorted(s["name"] for s in spans if s["parent"] == batch["id"]) == sorted(BATCH_CHILDREN)


def test_serve_forwards_counts_one_per_forward_including_a_split_group(predictor):
    """``serve.forwards``: three requests through predict_batch at max_batch
    2 are two forwards; a group of 2 and a group of 1 through MicroBatcher
    two more; the recorder off or on."""
    def forwards():
        return trace.drain(keep=True)["counters"]["serve.forwards"]

    start = forwards()
    assert start == serve.FORWARDS.count
    predictor.predict_batch([(_clip(seed=k), f"a person {k}", None) for k in range(3)])
    assert forwards() == start + 2
    trace.enable()
    with MicroBatcher(predictor, max_wait_ms=500) as mb:
        for f in [mb.submit(_clip(seed=k), f"a person {k}") for k in range(2)]:
            f.result(timeout=120)
        mb.submit(_clip(seed=2), "a person alone").result(timeout=120)
    assert forwards() == start + 4
    assert len(by_name(trace.drain()["spans"], "serve.forward")) == 2


def test_k3_dilated_is_registered_and_stays_zero_on_r101(predictor):
    """``k3.dilated`` sits beside ``k3.launches`` in every drain; an R101
    body (no DC5) launches no dilated block. On the card a DC5 body adds 2
    (tests/test_torch_cuda.py)."""
    counters = trace.drain()["counters"]
    assert counters["k3.dilated"] == pkb.DILATED.count
    predictor.predict(_clip(), "a person waves")
    assert trace.drain()["counters"]["k3.dilated"] == counters["k3.dilated"]
    body = predictor.model.vis_encoder[0].body
    assert all(b.dilation == 1 for i in range(4) for b in getattr(body, f"layer{i + 1}"))


@pytest.mark.parametrize("dc5", [False, True], ids=["r101", "dc5"])
def test_serve_forward_carries_its_rows_canvas_and_backbone_size(dc5):
    """``serve.forward``'s attrs: the rows (2 lanes x 2 streams x the
    8-frame bucket), the canvas prepare built, and the backbone's output
    [h, w] as the body's forward makes it (stride 32, or 16 with DC5)."""
    cfg = tiny("MODEL.VISION_BACKBONE.DILATION", "true" if dc5 else "false")
    pred = GroundingPredictor(cfg, state_dict=build_model(cfg, device="cpu", seed=0).state_dict(),
                              max_batch=2, device="cpu")
    body = pred.model.vis_encoder[0].body
    seen = []
    hook = body.register_forward_hook(lambda m, a, out: seen.append(list(out.shape[1:3])))
    trace.enable()
    try:
        pred.predict(_clip(), "a person waves")
    finally:
        hook.remove()
    (fwd,) = by_name(trace.drain()["spans"], "serve.forward")
    raw, _, _ = pred.prepare([(_clip(), "a person waves", None)])
    h, w = raw.out_canvas
    assert fwd["attrs"] == {"rows": 2 * 2 * 8, "canvas": [h, w], "backbone_hw": seen[0]}
    stride = 16 if dc5 else 32
    assert seen[0] == [-(-h // stride), -(-w // stride)]


# --------------------------------------------------------------------------
# evaluation and training
# --------------------------------------------------------------------------

def test_do_eval_records_its_phases_in_order(tmp_path):
    """5 test items in batches of 2 (3 batches, drained two behind): per
    batch next_batch, forward, postprocess; each drain holds its readback
    and merge; the prefetch thread records its places."""
    cfg = tiny("DATA_DIR", str(tmp_path), "INPUT.SAMPLE_FPS", 2, "INPUT.MAX_QUERY_LEN", 12,
               "TPU.FRAME_BUCKETS", "[16]", "DATALOADER.NUM_WORKERS", 1)
    loader = Loader(cfg, make_synthetic_dataset(cfg, "test", n_items=5, n_frames=15),
                    global_batch=2, is_train=False)
    model = build_model(cfg, device="cpu", seed=0)
    trace.enable()
    do_eval(cfg, model, loader, build_evaluator(cfg))
    spans = trace.drain()["spans"]
    main = sorted((s for s in spans if s["thread"] == threading.get_ident()),
                  key=lambda s: s["start_ns"])
    top = [s["name"] for s in main if s["parent"] is None]
    step = ["eval.next_batch", "eval.forward", "eval.postprocess"]
    assert top == step * 3 + ["eval.drain"] + ["eval.next_batch", "eval.drain", "eval.drain"]
    for d in by_name(spans, "eval.drain"):
        kids = sorted((s for s in spans if s["parent"] == d["id"]), key=lambda s: s["start_ns"])
        assert [s["name"] for s in kids] == ["eval.readback", "eval.merge"]
    places = by_name(spans, "prefetch.place")
    assert len(places) == 3
    assert all(p["thread_name"] == "device-prefetch" for p in places)


def _loop_cfg(tmp_path, *opts):
    return tiny(*LOOP, "DATA_DIR", str(tmp_path / "data"), "OUTPUT_DIR", str(tmp_path / "out"),
                *opts)


def _builder(cfg, split):
    return make_synthetic_dataset(cfg, split, n_items=4, n_frames=12)


def test_train_loop_times_come_from_its_spans(tmp_path, monkeypatch):
    """Every iteration logged: each metrics.jsonl row's data_time is its
    train.next_batch span's length and step_time runs from that span's
    start to its train.step's end; each step holds grads, optimizer and
    EMA in that order."""
    monkeypatch.setattr(ploop, "LOG_PERIOD", 1)
    cfg = _loop_cfg(tmp_path)
    trace.enable()
    ploop.train(cfg, _builder, max_iters=2, device="cpu")
    spans = trace.drain()["spans"]
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    waits, steps = by_name(spans, "train.next_batch"), by_name(spans, "train.step")
    assert [r["step"] for r in rows] == [1, 2] and len(waits) == len(steps) == 2
    for row, w, s in zip(rows, waits, steps):
        assert w["end_ns"] <= s["start_ns"]
        assert row["data_time"] == (w["end_ns"] - w["start_ns"]) / 1e9
        assert row["step_time"] == (s["end_ns"] - w["start_ns"]) / 1e9
        kids = sorted((k for k in spans if k["parent"] == s["id"]), key=lambda k: k["start_ns"])
        assert [k["name"] for k in kids] == ["train.grads", "train.optimizer", "train.ema"]


def test_profile_step_trace_holds_the_ports_train_spans(tmp_path):
    """TPU.PROFILE_STEP 1 over 4 iterations: steps 2-4 are profiled and
    their port spans land in the Chrome trace beside the profiler's
    events, on its clock; the recorder is off and empty afterwards."""
    cfg = _loop_cfg(tmp_path, "TPU.PROFILE_STEP", 1)
    ploop.train(cfg, _builder, max_iters=4, device="cpu")
    assert not trace.enabled() and trace.drain()["spans"] == []
    with open(tmp_path / "out" / "trace" / "steps_4.json") as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "stcat_tpu_torch"]
    names = [e["name"] for e in ours]
    for name in ("train.next_batch", "train.step", "train.grads", "train.optimizer",
                 "train.ema"):
        assert names.count(name) == 3, name
    theirs = [e for e in events if e.get("ph") == "X" and e.get("cat") != "stcat_tpu_torch"]
    assert theirs
    lo = min(e["ts"] for e in theirs)
    hi = max(e["ts"] + e["dur"] for e in theirs)
    grads = [e for e in ours if e["name"] == "train.grads"]
    assert all(lo - 1e3 <= e["ts"] and e["ts"] + e["dur"] <= hi + 1e3 for e in grads)


def test_profile_step_leaves_an_operators_recording_in_place(tmp_path):
    """With the recorder on before train(), TPU.PROFILE_STEP adds to its
    trace only the spans begun in the profiled steps and drains nothing:
    the recorder stays on and still holds all four iterations' spans."""
    cfg = _loop_cfg(tmp_path, "TPU.PROFILE_STEP", 1)
    trace.enable()
    ploop.train(cfg, _builder, max_iters=4, device="cpu")
    assert trace.enabled()
    spans = trace.drain()["spans"]
    assert len(by_name(spans, "train.step")) == len(by_name(spans, "train.next_batch")) == 4
    with open(tmp_path / "out" / "trace" / "steps_4.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "stcat_tpu_torch"]
    assert names.count("train.step") == names.count("train.next_batch") == 3
