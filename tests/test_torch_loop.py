"""The port's training loop and what it runs on, on the CPU.

Host utilities (prefetch, the metrics writer, checkpoints), weights in and
out (reference and MDETR torch files, checkpoint restore), a
SIGTERM-interrupted run resumed against an uninterrupted one, and the
training CLI. The port's ``train()`` against the JAX package's:
tests/test_torch_slice.py. The tiny model is tests/test_torch_train.py's.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from stcat_tpu.config import merge_from_list
from test_torch_train import NO_DROPOUT, port_cfg

from stcat_tpu_torch.convert import from_jax_variables
from stcat_tpu_torch.core.batch import VideoTargets
from stcat_tpu_torch.core.metrics_writer import MetricsWriter
from stcat_tpu_torch.core.prefetch import device_prefetch, prefetch_to_device
from stcat_tpu_torch.data.synthetic import make_synthetic_dataset
from stcat_tpu_torch.models import build_model
from stcat_tpu_torch.train import loop as ploop
from stcat_tpu_torch.train.checkpoint import Checkpointer, load_weights_for_eval
from stcat_tpu_torch.train.convert_reference import load_pretrained_weight, remap_mdetr
from stcat_tpu_torch.train.optimizer import make_optimizer
from stcat_tpu_torch.train.step import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------
# device_prefetch (tests/test_prefetch.py's cases) and the CPU placement
# --------------------------------------------------------------------------

def test_prefetch_keeps_order():
    assert list(device_prefetch(range(20), lambda x: x * 2, depth=3)) == \
        [x * 2 for x in range(20)]


def test_prefetch_place_error_reraises_at_the_consumer():
    def place(x):
        if x == 3:
            raise ValueError("boom")
        return x

    got = []
    with pytest.raises(ValueError, match="boom"):
        for v in device_prefetch(range(10), place, depth=2):
            got.append(v)
    assert got == [0, 1, 2]


def test_prefetch_iterator_error_reraises_at_the_consumer():
    def src():
        yield 1
        raise RuntimeError("src died")

    with pytest.raises(RuntimeError, match="src died"):
        list(device_prefetch(src(), lambda x: x))


def test_prefetch_close_stops_the_worker():
    started, n_placed = threading.Event(), [0]

    def place(x):
        started.set()
        n_placed[0] += 1
        return x

    gen = device_prefetch(iter(range(10_000)), place, depth=1)
    assert next(gen) == 0
    assert started.wait(5)
    gen.close()  # must not hang on a full queue
    time.sleep(0.3)
    after_close = n_placed[0]
    time.sleep(0.3)
    assert n_placed[0] <= after_close + 1


def test_prefetch_places_while_the_consumer_holds_an_item():
    in_place, seen = threading.Event(), []

    def place(x):
        in_place.set()
        time.sleep(0.05)
        in_place.clear()
        return x

    gen = device_prefetch(range(6), place, depth=2)
    next(gen)
    time.sleep(0.02)
    seen.append(in_place.is_set())
    assert list(gen) == [1, 2, 3, 4, 5]
    assert any(seen)


def test_prefetch_to_device_on_the_cpu():
    """Loader items (containers of numpy arrays, a meta list) come out in
    order with every array a tensor of the same values; meta passes as is."""
    items = [(VideoTargets(boxes=np.full((1, 2, 4), i, np.float32),
                           box_valid=np.ones((1, 2), bool),
                           actioness=np.zeros((1, 2), np.float32),
                           temp_bound=np.asarray([[0, 1]], np.int32)), [{"i": i}])
             for i in range(5)]
    out = list(prefetch_to_device(iter(items), "cpu", depth=2))
    assert [m for _, m in out] == [m for _, m in items]
    for (t, _), (src, _) in zip(out, items):
        for f in dataclasses.fields(t):
            v = getattr(t, f.name)
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), getattr(src, f.name))


def test_metrics_writer_appends_jsonl(tmp_path):
    w = MetricsWriter(str(tmp_path))
    w.write(1, {"loss": 2.5, "lr_rest": 1e-4})
    w.write(2, {"loss": 2.0})
    w.close()
    w = MetricsWriter(str(tmp_path))
    w.write(3, {"loss": 1.5})
    w.close()
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert rows[0]["loss"] == 2.5 and rows[0]["lr_rest"] == 1e-4 and "time" in rows[0]


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _tiny_state(cfg, seed=0):
    model = build_model(cfg, device="cpu", seed=seed)
    opt = make_optimizer(cfg, model, num_training_steps=10)
    return create_train_state(cfg, model, opt)


def _take_step(state, scale):
    """An optimizer step on made-up gradients, then the EMA, in place."""
    for p in state.model.parameters():
        p.grad = torch.full_like(p, scale)
    state.optimizer.step()
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            state.ema[n].mul_(0.5).add_(p, alpha=0.5)
    state.step += 1


@pytest.fixture(scope="module")
def tiny_cfg_port():
    return port_cfg(tiny_cfg(NO_DROPOUT))


def _flat(state):
    """Every number a checkpoint carries, by name."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in state.ema.items()})
    for i, st in state.optimizer.core.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": torch.as_tensor(v) for k, v in st.items()})
    out["count"] = torch.tensor(state.optimizer.count)
    out["step"] = torch.tensor(state.step)
    return out


def test_checkpoint_tag_moves_only_after_commit(tmp_path, tiny_cfg_port, monkeypatch):
    """save() snapshots before it returns (an in-place update right after it
    does not reach the file) and writes in the background; the tag moves in
    flush(), once the file has committed; a failed write raises at flush and
    leaves the tag where it was; saving a step twice is a no-op; ``keep``
    files stay. A fresh state restored from a step equals the saved one
    bitwise: weights, buffers, EMA, AdamW moments, count and step."""
    cfg = tiny_cfg_port
    state = _tiny_state(cfg)
    ckpt = Checkpointer(str(tmp_path), keep=2)
    assert ckpt.last_step() is None and not ckpt.has_checkpoint()
    _take_step(state, 1.0)
    saved1 = {k: v.clone() for k, v in _flat(state).items()}
    updated, real_save = threading.Event(), torch.save

    def save_after_the_update(*args, **kwargs):  # the writer runs after the next step
        assert updated.wait(30)
        real_save(*args, **kwargs)

    monkeypatch.setattr(torch, "save", save_after_the_update)
    ckpt.save(1, state)
    assert ckpt.last_step() is None  # written in the background; the tag waits for flush
    _take_step(state, -2.0)          # the next step updates in place right away
    updated.set()
    ckpt.flush()
    monkeypatch.setattr(torch, "save", real_save)
    assert ckpt.last_step() == 1
    assert ckpt.last_stats["bytes"] == os.path.getsize(ckpt.path(1))

    saved2 = {k: v.clone() for k, v in _flat(state).items()}
    ckpt.save(2, state)
    ckpt.save(2, state, block=True)  # the final save at a step just saved: no-op
    assert ckpt.last_step() == 2
    for step, want in ((1, saved1), (2, saved2)):
        fresh = _tiny_state(cfg, seed=5)
        fresh, got_step = ckpt.restore(fresh, step=step)
        assert got_step == step == fresh.step
        got = _flat(fresh)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (step, k)

    def disk_full(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", disk_full)
    ckpt.save(3, state)
    with pytest.raises(OSError, match="disk full"):
        ckpt.flush()
    monkeypatch.setattr(torch, "save", real_save)
    assert ckpt.last_step() == 2
    ckpt.save(4, state, block=True)
    ckpt.save(5, state, block=True)
    assert ckpt.last_step() == 5
    assert sorted(os.listdir(ckpt.dir)) == ["last_checkpoint", "model_00000004.pt",
                                            "model_00000005.pt"]


def test_restore_for_eval_prefers_ema_and_refuses_mismatches(tmp_path, tiny_cfg_port):
    """restore_for_eval hands back the EMA weights with the model's buffers;
    load_weights_for_eval reads a run's OUTPUT_DIR or its checkpoints/; a
    checkpoint of another shape or other keys is refused."""
    cfg = tiny_cfg_port
    state = _tiny_state(cfg)
    _take_step(state, 1.0)
    Checkpointer(str(tmp_path)).save(1, state, block=True)
    template = build_model(cfg, device="cpu", seed=3).state_dict()
    sd = Checkpointer(str(tmp_path)).restore_for_eval(template)
    assert sd.keys() == template.keys()
    params = dict(state.model.named_parameters())
    for k, v in sd.items():
        want = state.ema[k] if k in params else state.model.state_dict()[k]
        assert torch.equal(v, want), k
    assert not torch.equal(state.ema["input_proj.weight"], params["input_proj.weight"])
    for where in (str(tmp_path), str(tmp_path / "checkpoints") + "/"):
        model = build_model(cfg, device="cpu", seed=3)
        load_weights_for_eval(model, where)
        for k, v in model.state_dict().items():
            assert torch.equal(v, sd[k]), k

    wider = port_cfg(tiny_cfg(NO_DROPOUT + ["MODEL.STCAT.FFN_DIM", 96]))
    with pytest.raises(ValueError, match="shape"):
        load_weights_for_eval(build_model(wider, device="cpu"), str(tmp_path))
    deeper = port_cfg(tiny_cfg(NO_DROPOUT + ["MODEL.STCAT.DEC_LAYERS", 3]))
    with pytest.raises(ValueError, match="keys differ"):
        load_weights_for_eval(build_model(deeper, device="cpu"), str(tmp_path))


# --------------------------------------------------------------------------
# reference and MDETR torch files
# --------------------------------------------------------------------------

class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)

    warning = info


def test_reference_pth_loads_and_reports_unused_keys(tmp_path, tiny_cfg_port):
    """A reference-named .pth (a {"model": state_dict} file, with a BN step
    counter and one stray key) initialises every weight; the EMA starts as a
    copy; the stray key is reported, the known leftovers are not."""
    cfg = tiny_cfg_port
    src = build_model(cfg, device="cpu", seed=1).state_dict()
    extra = {"vis_encoder.0.body.bn1.num_batches_tracked": torch.tensor(3),
             "stray.weight": torch.zeros(2)}
    path = str(tmp_path / "ref.pth")
    torch.save({"model": {**src, **extra}}, path)
    state, log = _tiny_state(cfg), _Log()
    load_pretrained_weight(dataclasses.replace(cfg, MODEL=dataclasses.replace(
        cfg.MODEL, WEIGHT=path)), state, log)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, src[k]), k
    for k, v in state.ema.items():
        assert torch.equal(v, src[k]), k
    unused = [line for line in log.lines if "unused" in line]
    assert len(unused) == 1 and "stray.weight" in unused[0] and "num_batches" not in unused[0]
    missing = {k: v for k, v in src.items() if k != "input_proj.weight"}
    torch.save(missing, path)
    with pytest.raises(KeyError, match="input_proj.weight"):
        load_pretrained_weight(dataclasses.replace(cfg, MODEL=dataclasses.replace(
            cfg.MODEL, WEIGHT=path)), _tiny_state(cfg), log)


def _to_mdetr(sd):
    """A reference-named state_dict under MDETR's names (remap_mdetr's
    inverse), the sections MDETR does not have left out."""
    renames = [("vis_encoder.", "backbone."), ("text_encoder.body.", "transformer.text_encoder."),
               ("text_encoder.resizer.", "transformer.resizer."),
               ("ground_encoder.encoder.spatial_layers.", "transformer.encoder.layers."),
               ("ground_decoder.decoder.", "transformer.decoder.decoder."),
               ("input_proj.", "input_proj."), ("bbox_embed.", "bbox_embed.")]
    out = {}
    for k, v in sd.items():
        for a, b in renames:
            if k.startswith(a):
                out[b + k[len(a):]] = v
                break
    return out


def test_mdetr_partial_init_matches_jax(tmp_path, tiny_cfg_port):
    """An MDETR-shaped checkpoint (a seed-1 model under MDETR's names, one
    spatial-decoder weight missing, MDETR-only keys added) initialises a
    seed-0 model as the JAX chain does: remap_mdetr ->
    convert_reference_stcat(strict=False) -> merge_partial over the fresh
    JAX parameters -> from_jax_variables. Exact: both only copy."""
    from stcat_tpu.train.convert_reference import (
        convert_reference_stcat, merge_partial, remap_mdetr as jremap)

    cfg = tiny_cfg_port
    jcfg = tiny_cfg(NO_DROPOUT)
    fresh = build_model(cfg, device="cpu", seed=0).state_dict()
    donor = build_model(cfg, device="cpu", seed=1).state_dict()
    md = _to_mdetr(donor)
    dropped = next(k for k in md if k.startswith("transformer.decoder.decoder."))
    del md[dropped]
    md["transformer.contrastive_align.weight"] = torch.zeros(3)
    md["class_embed.weight"] = torch.zeros(4, 2)
    assert set(remap_mdetr(md)) == set(jremap(md))
    path = str(tmp_path / "mdetr.pth")
    torch.save({"model": md}, path)

    state = _tiny_state(cfg, seed=0)
    load_pretrained_weight(dataclasses.replace(cfg, MODEL=dataclasses.replace(
        cfg.MODEL, WEIGHT=path)), state, _Log())
    got = state.model.state_dict()

    base_p, base_c, _ = convert_reference_stcat(fresh, jcfg)
    part_p, part_c, _ = convert_reference_stcat(jremap(md), jcfg, strict=False)
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, merge_partial(base_p, part_p)),
                              jax.tree_util.tree_map(np.asarray, merge_partial(base_c, part_c)))
    assert got.keys() == want.keys()
    took = {k for k in got if not torch.equal(got[k], fresh[k])}
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert any(k.startswith("vis_encoder.") for k in took)
    assert any(k.startswith("text_encoder.") for k in took)
    assert not any(k.startswith("ground_decoder.decoder.") for k in took)  # incomplete
    for k in took:
        assert torch.equal(state.ema[k], donor[k]), k


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

LR = 1e-3
LOOP = ["INPUT.RESOLUTION", 64, "INPUT.TRAIN_SAMPLE_NUM", 8, "INPUT.MAX_QUERY_LEN", 12,
        # one frame bucket and no scale or crop augmentation: every batch has
        # one shape, so the JAX step compiles once
        "INPUT.AUG_SCALE", "false", "INPUT.AUG_CROP", "false", "TPU.FRAME_BUCKETS", "[8]",
        "MODEL.STCAT.ENC_LAYERS", 1, "MODEL.TEXT_MODEL.LAYERS", 1, "MODEL.EMA_DECAY", 0.5,
        "SOLVER.BATCH_SIZE", 2, "SOLVER.MAX_EPOCH", 2, "SOLVER.CHECKPOINT_PERIOD", 2,
        "SOLVER.TO_VAL", "false", "SOLVER.WARMUP_PROP", 0.0,
        "SOLVER.BASE_LR", LR, "SOLVER.TEMP_LR", LR, "SOLVER.TEXT_LR", LR,
        "SOLVER.VIS_BACKBONE_LR", LR, "DATALOADER.NUM_WORKERS", 1]


def _loop_cfg(tmp_path, out, extra=()):
    return tiny_cfg(NO_DROPOUT + LOOP + ["DATA_DIR", str(tmp_path / "data"),
                                         "OUTPUT_DIR", str(tmp_path / out), *extra])


def _builder(cfg, split):
    return make_synthetic_dataset(cfg, split, n_items=4, n_frames=12)


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


def test_sigterm_and_resume_equal_an_uninterrupted_run(tmp_path, monkeypatch):
    """With the recipe's dropout on (so the per-step generators matter) and
    AdamW: 4 uninterrupted iterations, against a run stopped by SIGTERM
    after iteration 2 (a blocking checkpoint at 2, then the loop stops) and
    resumed by a second train() at the same max_iters. Bitwise equal on the
    CPU: parameters, buffers, EMA, AdamW moments, count. The LRs of every
    iteration are the same in both (same max_iters)."""
    jwhole = tiny_cfg(LOOP + ["DATA_DIR", str(tmp_path / "data"),
                              "OUTPUT_DIR", str(tmp_path / "whole")])
    assert jwhole.SOLVER.OPTIMIZER == "adamw"
    assert jwhole.MODEL.STCAT.DROPOUT > 0
    whole, it = ploop.train(port_cfg(jwhole), _builder, max_iters=4, device="cpu")
    assert it == 4

    cfg = port_cfg(merge_from_list(jwhole, ["OUTPUT_DIR", str(tmp_path / "cut")]))
    handler = signal.getsignal(signal.SIGTERM)
    with monkeypatch.context() as m:
        _interrupt_at(m, 2)
        first, it1 = ploop.train(cfg, _builder, max_iters=4, device="cpu")
    assert it1 == 2 and Checkpointer(cfg.OUTPUT_DIR).last_step() == 2
    assert signal.getsignal(signal.SIGTERM) is handler
    resumed, it2 = ploop.train(cfg, _builder, max_iters=4, device="cpu")
    assert it2 == 4 and Checkpointer(cfg.OUTPUT_DIR).last_step() == 4

    a, b = _flat(whole), _flat(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_cli_train_runs_to_its_end(tmp_path):
    """python -m stcat_tpu_torch.cli.train --synthetic --device cpu: 4
    iterations over the first 2 items (DATA_TRUNK) with validation at 2 and
    a profiler trace of steps 2-4; the saved config.yml loads back; metrics,
    validation and checkpoints are where the loop writes them."""
    from stcat_tpu_torch.config import default_config, merge_from_file

    out = tmp_path / "out"
    opts = ["MODEL.VISION_BACKBONE.DEPTHS", "[1,1,1,1]", "MODEL.STCAT.HIDDEN", "64",
            "MODEL.STCAT.HEADS", "4", "MODEL.STCAT.FFN_DIM", "128", "MODEL.STCAT.ENC_LAYERS", "1",
            "MODEL.STCAT.DEC_LAYERS", "2", "MODEL.TEXT_MODEL.VOCAB_SIZE", "128",
            "MODEL.TEXT_MODEL.HIDDEN", "32", "MODEL.TEXT_MODEL.LAYERS", "1",
            "MODEL.TEXT_MODEL.HEADS", "2", "MODEL.TEXT_MODEL.INTERMEDIATE", "64",
            "MODEL.TEXT_MODEL.MAX_POS", "64", "INPUT.MAX_VIDEO_LEN", "32",
            "TPU.COMPUTE_DTYPE", "float32", "INPUT.RESOLUTION", "64",
            "INPUT.TRAIN_SAMPLE_NUM", "4", "INPUT.MAX_QUERY_LEN", "12", "DATA_TRUNK", "2",
            "TPU.FRAME_BUCKETS", "[4,8]", "SOLVER.VAL_PERIOD", "2",
            "SOLVER.CHECKPOINT_PERIOD", "3", "TPU.PROFILE_STEP", "1",
            "DATALOADER.NUM_WORKERS", "1", "DATA_DIR", str(tmp_path / "data"),
            "OUTPUT_DIR", str(out)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=str(torch.get_num_threads()))
    res = subprocess.run([sys.executable, "-m", "stcat_tpu_torch.cli.train", "--synthetic",
                          "--device", "cpu", "--max-iters", "4", *opts],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    cfg = merge_from_file(default_config(), str(out / "config.yml"))
    assert cfg.MODEL.STCAT.HIDDEN == 64 and cfg.SOLVER.VAL_PERIOD == 2
    assert Checkpointer(str(out)).last_step() == 4
    assert sorted(os.listdir(out / "checkpoints")) == ["last_checkpoint", "model_00000003.pt",
                                                       "model_00000004.pt"]
    with open(out / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [4]
    with open(out / "validation.jsonl") as f:
        val = [json.loads(line) for line in f]
    assert [v["step"] for v in val] == [2] and val[0]["batches"] == 2
    assert all(0.0 <= v <= 1.0 for k, v in val[0].items() if "iou" in k)
    assert os.path.exists(out / "trace" / "steps_4.json")
