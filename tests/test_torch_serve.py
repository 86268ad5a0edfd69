"""The port's serving path against the JAX package's, on the CPU.

One module-scoped pair of predictors shares weights: the JAX
``GroundingPredictor`` initialises the tiny model (the config of
tests/test_serve.py) and the port's predictor loads the same variables
through ``from_jax_variables``. Both run the full path -- host plan and raw
batch, on-device preprocess, STCATNet, postprocess, two-stream merge -- in
fp32. Boxes are in original pixels: atol 1e-2 px. Spans must be identical.

The staging of requests (``GroundingPredictor.stage``, run by
``MicroBatcher.submit`` on its staging thread) is held to the batch the
predictor built before it staged anything: ``build_raw_batch`` of the
lanes' stream samples, then ``to_device``, bit for bit.
"""

import concurrent.futures
import dataclasses
import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from stcat_tpu.data.tokenize import HashTokenizer as JaxHashTokenizer
from stcat_tpu.serve import GroundingPredictor as JaxPredictor

from stcat_tpu_torch import config as pconfig
from stcat_tpu_torch import serve
from stcat_tpu_torch.convert import from_jax_variables
from stcat_tpu_torch.data.batching import _place, place_canvas
from stcat_tpu_torch.serve import GroundingPredictor, MicroBatcher
from torch_staging import built_before_staging, staged

OPTS = ["INPUT.RESOLUTION", 64, "INPUT.MAX_QUERY_LEN", 8, "TPU.FRAME_BUCKETS", "[8]"]


@pytest.fixture(scope="module")
def predictors():
    from stcat_tpu.config import to_dict

    cfg = tiny_cfg(OPTS)
    jax_pred = JaxPredictor(cfg, max_batch=2)
    # both sides use the hash tokenizer whatever tokenizer files the host has
    jax_pred.tokenizer = JaxHashTokenizer(cfg.MODEL.TEXT_MODEL.VOCAB_SIZE)
    params = jax.tree_util.tree_map(np.asarray, jax_pred.params)
    consts = jax.tree_util.tree_map(np.asarray, jax_pred.constants)
    pcfg = pconfig._merge_dict(pconfig.default_config(), to_dict(cfg))
    port = GroundingPredictor(pcfg, state_dict=from_jax_variables(params, consts),
                              max_batch=2, device="cpu")
    return jax_pred, port


def _clip(t=12, h=48, w=64, seed=0):
    return np.random.RandomState(seed).randint(0, 255, size=(t, h, w, 3), dtype=np.uint8)


def _assert_same(ours, theirs):
    assert set(ours) == {"boxes", "span"}
    assert sorted(ours["boxes"]) == sorted(theirs["boxes"])
    for fid, box in theirs["boxes"].items():
        np.testing.assert_allclose(ours["boxes"][fid], box, atol=1e-2, rtol=0, err_msg=str(fid))
    assert list(ours["span"]) == list(theirs["span"])


def test_normal_clip_matches_jax(predictors):
    jax_pred, port = predictors
    clip = _clip()
    ours = port.predict(clip, "a person waves at the camera")
    _assert_same(ours, jax_pred.predict(clip, "a person waves at the camera"))
    assert sorted(ours["boxes"]) == list(range(12))


def test_single_frame_clip_matches_jax(predictors):
    jax_pred, port = predictors
    clip = _clip(t=1, seed=3)
    ours = port.predict(clip, "one frame")
    _assert_same(ours, jax_pred.predict(clip, "one frame"))
    assert ours["span"] == [0, 1]


def test_single_frame_clip_shares_a_batch_with_a_longer_one(predictors):
    """A single-frame clip (its second stream is padding) and a 12-frame
    clip in one batch: each answer equals the JAX predictor's for that clip
    alone. (The JAX predictor's stream merge raises KeyError on this batch;
    the port's merge keeps the single-frame clip's first stream.)"""
    jax_pred, port = predictors
    reqs = [(_clip(t=1, seed=3), "one frame", None), (_clip(seed=5), "a longer clip", None)]
    ours = port.predict_batch(reqs)
    for (clip, text, _), got in zip(reqs, ours):
        _assert_same(got, jax_pred.predict(clip, text))
    with pytest.raises(KeyError):
        jax_pred.predict_batch(reqs)


def test_sparse_frame_ids_match_jax(predictors):
    jax_pred, port = predictors
    clip, fids = _clip(t=8, seed=4), [3, 5, 7, 9, 11, 13, 15, 17]
    ours = port.predict(clip, "a child on a bike", frame_ids=fids)
    _assert_same(ours, jax_pred.predict(clip, "a child on a bike", frame_ids=fids))
    assert sorted(ours["boxes"]) == list(range(3, 18))


def test_overflow_batch_matches_jax(predictors):
    jax_pred, port = predictors
    reqs = [(_clip(seed=i), f"clip {i} turns left", None) for i in range(3)]
    ours = port.predict_batch(reqs)
    theirs = jax_pred.predict_batch(reqs)
    assert len(ours) == len(theirs) == 3
    for o, t in zip(ours, theirs):
        _assert_same(o, t)


def test_micro_batcher_concurrent_matches_jax(predictors):
    jax_pred, port = predictors
    reqs = [(_clip(seed=10 + i), f"request {i}", None) for i in range(5)]
    theirs = jax_pred.predict_batch(reqs)
    with MicroBatcher(port, max_wait_ms=20.0) as mb:
        with concurrent.futures.ThreadPoolExecutor(5) as pool:
            futs = list(pool.map(lambda r: mb.submit(r[0], r[1]), reqs))
        done = concurrent.futures.wait(futs, timeout=300)
        assert not done.not_done
        for fut, t in zip(futs, theirs):
            _assert_same(fut.result(), t)


def test_micro_batcher_propagates_errors(predictors):
    _, port = predictors
    with MicroBatcher(port) as mb:
        bad = mb.submit(np.zeros((4, 8, 8), np.uint8), "not 4d")
        with pytest.raises(ValueError):
            bad.result(timeout=60)


def test_predictor_loads_model_weight(predictors, tmp_path):
    """MODEL.WEIGHT naming a training run's checkpoint directory serves the
    EMA weights (the model's buffers beside them): the same answers, exactly,
    as a predictor handed that state_dict. A reference-named .pth is refused
    with the hash tokenizer unless ALLOW_HASH_TOKENIZER opts in, and then
    serves its weights."""
    import dataclasses

    import torch

    from stcat_tpu_torch.models import build_model
    from stcat_tpu_torch.train.checkpoint import Checkpointer
    from stcat_tpu_torch.train.optimizer import make_optimizer
    from stcat_tpu_torch.train.step import create_train_state

    _, port = predictors
    cfg = port.cfg
    model = build_model(cfg, device="cpu", seed=1)
    state = create_train_state(cfg, model, make_optimizer(cfg, model, num_training_steps=4))
    gen = torch.Generator().manual_seed(2)
    for p in state.ema.values():
        p.add_(torch.randn(p.shape, generator=gen) * 1e-2)
    state.step = 3
    Checkpointer(str(tmp_path / "run")).save(3, state, block=True)
    served = {**model.state_dict(), **state.ema}

    def with_weight(weight, **model_kw):
        return dataclasses.replace(cfg, MODEL=dataclasses.replace(cfg.MODEL, WEIGHT=weight,
                                                                  **model_kw))

    clip = _clip(seed=6)
    want = GroundingPredictor(cfg, state_dict=served, max_batch=2, device="cpu").predict(
        clip, "a person waves at the camera")
    got = GroundingPredictor(with_weight(str(tmp_path / "run")), max_batch=2,
                             device="cpu").predict(clip, "a person waves at the camera")
    assert got == want

    torch.save(model.state_dict(), str(tmp_path / "w.pth"))
    with pytest.raises(RuntimeError, match="HASH tokenizer"):
        GroundingPredictor(with_weight(str(tmp_path / "w.pth")), device="cpu")
    text = dataclasses.replace(cfg.MODEL.TEXT_MODEL, ALLOW_HASH_TOKENIZER=True)
    pth = GroundingPredictor(with_weight(str(tmp_path / "w.pth"), TEXT_MODEL=text), device="cpu")
    for k, v in pth.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_predictor_takes_weights_and_logger(predictors, tmp_path):
    """The JAX predictor's signature, GroundingPredictor(cfg, weights,
    logger, ...): ``weights`` wins over MODEL.WEIGHT and is logged through
    ``logger``; the tokenizer guard checks the path that is loaded (a
    reference .pth in weights is refused under the hash tokenizer though
    MODEL.WEIGHT is empty; a run directory in weights is taken though
    MODEL.WEIGHT names a .pth); a state_dict is loaded without a path guard;
    weights and state_dict together are refused."""
    import dataclasses
    import logging

    import torch

    from stcat_tpu_torch.models import build_model
    from stcat_tpu_torch.train.checkpoint import Checkpointer
    from stcat_tpu_torch.train.optimizer import make_optimizer
    from stcat_tpu_torch.train.step import create_train_state

    _, port = predictors
    cfg = port.cfg
    model = build_model(cfg, device="cpu", seed=4)
    state = create_train_state(cfg, model, make_optimizer(cfg, model, num_training_steps=4))
    Checkpointer(str(tmp_path / "run")).save(1, state, block=True)
    pth = str(tmp_path / "w.pth")
    torch.save(model.state_dict(), pth)
    with_pth = dataclasses.replace(cfg, MODEL=dataclasses.replace(cfg.MODEL, WEIGHT=pth))

    lines = []

    class Catch(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = logging.getLogger("test_predictor_weights")
    logger.addHandler(Catch())
    logger.setLevel(logging.INFO)
    pred = GroundingPredictor(with_pth, str(tmp_path / "run"), logger, max_batch=2,
                              device="cpu")
    for k, v in pred.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    assert any(str(tmp_path / "run") in line for line in lines)

    with pytest.raises(RuntimeError, match="HASH tokenizer"):
        GroundingPredictor(cfg, weights=pth, device="cpu")
    with pytest.raises(RuntimeError, match="HASH tokenizer"):
        GroundingPredictor(with_pth, device="cpu")
    sd = GroundingPredictor(with_pth, device="cpu", state_dict=model.state_dict())
    assert torch.equal(sd.model.input_proj.weight, model.input_proj.weight)
    with pytest.raises(ValueError, match="not both"):
        GroundingPredictor(cfg, weights=str(tmp_path / "run"), device="cpu",
                           state_dict=model.state_dict())


# --------------------------------------------------------------------------
# staging at arrival
# --------------------------------------------------------------------------

GROUPS = {
    "full_group": [(_clip(seed=1), "a person waves", None), (_clip(seed=2), "a dog runs", None)],
    "replica_lane": [(_clip(seed=3), "one request", None)],
    "two_lengths": [(_clip(t=12, seed=4), "a long clip", None),
                    (_clip(t=5, seed=5), "a short clip", None)],
    "two_sizes": [(_clip(t=6, h=64, w=64, seed=6), "a small clip", None),
                  (_clip(t=6, h=70, w=130, seed=7), "a wide clip", None)],
    "two_sizes_inner_row": [(_clip(t=6, h=48, w=100, seed=8), "a short frame", None),
                            (_clip(t=7, h=130, w=70, seed=9), "a tall frame", None)],
    "single_frame_beside_longer": [(_clip(t=1, seed=10), "one frame", None),
                                   (_clip(seed=11), "a longer clip", None)],
    "sparse_frame_ids": [(_clip(t=8, seed=12), "a child on a bike", [3, 5, 7, 9, 11, 13, 15, 17])],
}


@pytest.mark.parametrize("route", ["unstaged", "staged", "dirty"])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_prepare_and_place_give_the_batch_built_before_staging(predictors, monkeypatch, group,
                                                               route):
    """prepare + place, on requests staged ahead or staged in prepare, give
    the device batch and meta of build_raw_batch + to_device bit for bit:
    the frame tensor (canvas, replicated row and column, bucket padding,
    replica lanes) and every small array. ``dirty``: staged in prepare with
    every torch.empty (the staged canvases, the placed frame tensor) full
    of 255, so what is not written is not zero by chance."""
    _, port = predictors
    reqs = GROUPS[group]
    want, w1, w2 = built_before_staging(port, reqs)
    if route == "dirty":
        empty = torch.empty
        monkeypatch.setattr(torch, "empty", lambda *a, **k: empty(*a, **k).fill_(255))
    raw, m1, m2 = port.prepare(staged(port, reqs) if route == "staged" else reqs)
    got = port.place(raw)
    assert (m1, m2) == (w1, w2)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b), f.name
            if f.name != "frames_u8":
                np.testing.assert_array_equal(getattr(raw, f.name), b.numpy(), err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("t,h,w,hc,wc", [(3, 48, 64, 64, 64), (2, 64, 64, 64, 64),
                                         (1, 70, 130, 128, 192), (2, 1, 1, 64, 64)])
def test_place_canvas_zeroes_what_place_leaves_and_keeps_its_edges(t, h, w, hc, wc):
    """place_canvas on a canvas full of 255 equals _place on a zeroed one."""
    f = np.random.RandomState(h * w).randint(0, 255, (t, h, w, 3), dtype=np.uint8)
    dirty = np.full((t, hc, wc, 3), 255, np.uint8)
    clean = np.zeros_like(dirty)
    place_canvas(dirty, f)
    _place(clean, f, hc)
    np.testing.assert_array_equal(dirty, clean)


def test_micro_batcher_answers_equal_predict_batchs(predictors):
    """A group of two and a lone request through MicroBatcher (staged at
    submit) answer exactly as predict_batch (staged in prepare) does."""
    _, port = predictors
    reqs = [(_clip(seed=20 + i), f"request {i} walks left", None) for i in range(3)]
    want = port.predict_batch(reqs[:2]) + port.predict_batch(reqs[2:])
    with MicroBatcher(port, max_wait_ms=500) as mb:
        got = [f.result(timeout=120) for f in [mb.submit(*r) for r in reqs[:2]]]
        got.append(mb.submit(*reqs[2]).result(timeout=120))
    assert got == want


def test_a_staging_error_reaches_every_future_of_its_group(predictors):
    _, port = predictors
    with MicroBatcher(port, max_wait_ms=2000) as mb:
        futs = [mb.submit(_clip(), "a person waves"),
                mb.submit(np.zeros((4, 8, 8), np.uint8), "not 4d")]
        for f in futs:
            with pytest.raises(ValueError, match="T,H,W,3"):
                f.result(timeout=120)


def test_submit_returns_before_staging_ends(predictors, monkeypatch):
    """submit returns while the request's staging is held back, and the
    staging runs on the batcher's staging thread."""
    _, port = predictors
    clip = _clip(seed=30)
    want = port.predict(clip, "a person waves")
    gate, threads, stage = threading.Event(), [], port.stage

    def held(request):
        threads.append(threading.current_thread().name)
        assert gate.wait(60)
        return stage(request)

    monkeypatch.setattr(port, "stage", held)
    with MicroBatcher(port) as mb:
        t0 = time.perf_counter()
        fut = mb.submit(clip, "a person waves")
        took = time.perf_counter() - t0
        time.sleep(0.05)
        assert not fut.done()
        gate.set()
        assert fut.result(timeout=120) == want
    assert took < 30 and threads and threads[0].startswith(serve.STAGER)


def test_prepare_counts_staged_ready_waited_and_unstaged(predictors):
    """serve.staged_ready: staged by submit and done when prepare began;
    serve.staged_waited: staged by submit, not yet done then;
    serve.unstaged: a direct call's request. Through MicroBatcher every
    request is one of the first two."""
    _, port = predictors
    counters = (serve.STAGED_READY, serve.STAGED_WAITED, serve.UNSTAGED)

    def counts():
        return np.array([c.count for c in counters])

    (ready,) = staged(port, [(_clip(seed=40), "ready", None)])
    later = serve.Request(_clip(seed=41), "later", None)
    later.staged = Future()
    timer = threading.Timer(0.3, lambda: later.staged.set_result(port.stage(later)))
    start = counts()
    timer.start()
    port.prepare([ready, later])
    assert counts().tolist() == (start + [1, 1, 0]).tolist()
    port.predict_batch([(_clip(seed=42), "direct", None), (_clip(seed=43), "direct", None)])
    assert counts().tolist() == (start + [1, 1, 2]).tolist()
    with MicroBatcher(port, max_wait_ms=500) as mb:
        for f in [mb.submit(_clip(seed=44 + k), f"queued {k}") for k in range(3)]:
            f.result(timeout=120)
    ready_n, waited_n, unstaged_n = (counts() - start).tolist()
    assert ready_n + waited_n == 2 + 3 and unstaged_n == 2


def test_concurrent_submits_under_a_short_switch_interval(predictors):
    """More submitting threads than cores, the interpreter switching
    threads every 10 us: every request is answered as predict answers it
    alone, and counted once, as staged ready or waited."""
    import os
    import sys

    _, port = predictors
    n = (os.cpu_count() or 4) + 2
    reqs = [(_clip(t=4 + k % 5, seed=60 + k), f"person {k} turns", None) for k in range(n)]
    want = [port.predict(clip, text) for clip, text, _ in reqs]
    before = serve.STAGED_READY.count + serve.STAGED_WAITED.count, serve.UNSTAGED.count
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with MicroBatcher(port, max_wait_ms=5) as mb:
            with concurrent.futures.ThreadPoolExecutor(n) as pool:
                futs = list(pool.map(lambda r: mb.submit(*r), reqs))
            got = [f.result(timeout=300) for f in futs]
    finally:
        sys.setswitchinterval(interval)
    for g, w in zip(got, want):
        _assert_same(g, w)
    after = serve.STAGED_READY.count + serve.STAGED_WAITED.count, serve.UNSTAGED.count
    assert after == (before[0] + n, before[1])
