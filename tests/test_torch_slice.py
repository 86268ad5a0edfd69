"""The slice as a whole: the port's ``train()`` against the JAX package's
``train()``, on the CPU, from the same torch weights file and the same
synthetic data (its own file: the JAX loop compiles its step for about a
minute here)."""

import json
import os

import jax
import numpy as np
import torch

from stcat_tpu.config import merge_from_list
from test_torch_loop import _builder, _loop_cfg
from test_torch_train import port_cfg

from stcat_tpu_torch.convert import from_jax_variables
from stcat_tpu_torch.models import build_model
from stcat_tpu_torch.train import loop as ploop
from stcat_tpu_torch.train.checkpoint import Checkpointer

SGD_LRS = [k for g in ("BASE", "TEMP", "TEXT", "VIS_BACKBONE") for k in (f"SOLVER.{g}_LR", 0.5)]


def test_train_matches_jax_train(tmp_path, monkeypatch):
    """train() for 3 iterations (two epochs of 2 batches of 2 clips, cut at
    3; checkpoints at 2 and 3) from a reference .pth MODEL.WEIGHT, every
    dropout 0, against the JAX package's train() from the same file on the
    same synthetic data (its JPEG corpus decoded by the port's native
    libjpeg decoder and by PIL on the JAX side, its native decoder turned
    off here: the same pixels): parameters and
    EMA at atol 2e-4 / rtol 1e-3 (the model-parity tolerance). SGD: the update is proportional to the
    gradient, so the tolerance holds the gradients through the whole loop
    (Adam's first steps move every element by about +-LR whatever its
    gradient). The parameters move by far more than that tolerance."""
    from stcat_tpu.core.logging import setup_logger as jlogger
    import stcat_tpu.data.jpeg_decode as jjpeg
    from stcat_tpu.data.synthetic import make_synthetic_dataset as jsynthetic
    from stcat_tpu.train.loop import train as jtrain

    weight = str(tmp_path / "init.pth")
    jcfg = _loop_cfg(tmp_path, "jax", ["MODEL.WEIGHT", weight, "TPU.MESH_DATA", 1,
                                       "SOLVER.OPTIMIZER", "sgd", *SGD_LRS])
    cfg = port_cfg(merge_from_list(jcfg, ["OUTPUT_DIR", str(tmp_path / "port")]))
    init = build_model(cfg, device="cpu", seed=7).state_dict()
    torch.save(init, weight)

    state, it = ploop.train(cfg, _builder, max_iters=3, device="cpu")
    assert it == state.step == 3 and state.optimizer.count == 3
    assert Checkpointer(cfg.OUTPUT_DIR).last_step() == 3
    with open(os.path.join(cfg.OUTPUT_DIR, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [3]  # LOG_PERIOD 50: only the last iteration
    assert {"loss", "step_time", "data_time", "lr_rest"} <= set(rows[0])

    # the JAX loop on the same cache and JPEG corpus (written above)
    monkeypatch.setattr(jjpeg, "decode_jpeg_batch", lambda *a, **k: None)
    jstate, jit = jtrain(jcfg, lambda c, split: jsynthetic(c, split, n_items=4, n_frames=12),
                         logger=jlogger("jax-loop", rank=0), max_iters=3)
    assert jit == 3 and int(jstate.step) == 3
    consts = jax.tree_util.tree_map(np.asarray, jstate.constants)
    want_p = from_jax_variables(jax.tree_util.tree_map(np.asarray, jstate.params), consts)
    want_e = from_jax_variables(jax.tree_util.tree_map(np.asarray, jstate.ema_params), consts)
    moved = 0.0
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(), atol=2e-4,
                                   rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(), want_e[name].numpy(), atol=2e-4,
                                   rtol=1e-3, err_msg=name)
        moved = max(moved, (p.detach() - init[name]).abs().max().item())
    assert moved > 50 * 2e-4
