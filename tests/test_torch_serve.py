"""The port's serving path against the JAX package's, on the CPU.

One module-scoped pair of predictors shares weights: the JAX
``GroundingPredictor`` initialises the tiny model (the config of
tests/test_serve.py) and the port's predictor loads the same variables
through ``from_jax_variables``. Both run the full path -- host plan and raw
batch, on-device preprocess, STCATNet, postprocess, two-stream merge -- in
fp32. Boxes are in original pixels: atol 1e-2 px. Spans must be identical.
"""

import concurrent.futures

import jax
import numpy as np
import pytest

from helpers import tiny_cfg
from stcat_tpu.data.tokenize import HashTokenizer as JaxHashTokenizer
from stcat_tpu.serve import GroundingPredictor as JaxPredictor

from stcat_tpu_torch import config as pconfig
from stcat_tpu_torch.convert import from_jax_variables
from stcat_tpu_torch.serve import GroundingPredictor, MicroBatcher

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
