"""The learning proof (tests/test_learning.py) on the port.

tests/torch_learning.py runs it (torch only, so chip_smoke.py runs it on the
card too). Here its config is held to the JAX test's, read from that test's
source, and the proof itself runs on the CPU (``slow``: 900 iterations).
"""

import ast
import os
import shutil

import pytest

from helpers import tiny_cfg
from stcat_tpu.config import merge_from_list, to_dict

import torch_learning as tl
from stcat_tpu_torch import config as pconfig

HERE = os.path.dirname(os.path.abspath(__file__))


def _jax_test_opts():
    """The options test_overfit_moves_m_viou passes to tiny_cfg after
    DATA_DIR and OUTPUT_DIR, as literals from its source."""
    with open(os.path.join(HERE, "test_learning.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "test_overfit_moves_m_viou")
    call = next(n for n in ast.walk(fn)
                if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "tiny_cfg")
    elts = call.args[0].elts
    assert [ast.literal_eval(e) for e in elts[0:4:2]] == ["DATA_DIR", "OUTPUT_DIR"]
    return [ast.literal_eval(e) for e in elts[4:]]


def test_learning_config_is_the_jax_tests(tmp_path):
    """Same options, same values: the port's learning config equals the JAX
    test's config carried into the port's tree, key by key."""
    assert tl.LEARN_OPTS == _jax_test_opts()
    jcfg = merge_from_list(tiny_cfg(["DATA_DIR", str(tmp_path), "OUTPUT_DIR",
                                     str(tmp_path / "out")] + _jax_test_opts()), [])
    want = pconfig._merge_dict(pconfig.default_config(), to_dict(jcfg))
    assert tl.learning_cfg(str(tmp_path)) == want
    assert tl.ITERS == 900 and tl.learning_cfg(str(tmp_path)).SEED == jcfg.SEED


def test_builder_evaluates_the_trained_clips(tmp_path):
    """The test split is the train split's two clips, which share one span."""
    cfg = tl.learning_cfg(str(tmp_path))
    train, test = tl.builder(cfg, "train"), tl.builder(cfg, "test")
    assert len(train) == len(test) == 2
    for a, b in zip(train.items, test.items):
        assert (a["vid"], a["description"], a["gt_temp_bound"], a["bboxs"]) == \
            (b["vid"], b["description"], b["gt_temp_bound"], b["bboxs"])
    spans = {tuple(it["gt_temp_bound"]) for it in train.items}
    assert len(spans) == 1


def _jax_initial_weights(tmp_path):
    """The weights the JAX test's train() starts from (its init_variables
    with PRNGKey(SEED) on the first batch), as a port state_dict."""
    import jax
    import numpy as np

    from stcat_tpu.core.mesh import make_mesh
    from stcat_tpu.data.loader import make_loader
    from stcat_tpu.data.synthetic import make_synthetic_dataset
    from stcat_tpu.models import STCATNet
    from stcat_tpu.train.step import init_variables
    from stcat_tpu_torch.convert import from_jax_variables

    jcfg = tiny_cfg(["DATA_DIR", str(tmp_path / "jax"), "OUTPUT_DIR", str(tmp_path / "jax_out")]
                    + _jax_test_opts())
    ds = make_synthetic_dataset(jcfg, "train", n_items=2, n_frames=12, shared_span=True)
    sample = next(iter(make_loader(jcfg, ds, make_mesh(jcfg.TPU.MESH_DATA), "val")))
    variables = init_variables(jcfg, STCATNet(jcfg), jax.random.PRNGKey(jcfg.SEED),
                               jax.tree_util.tree_map(lambda x: x[:1], sample[0]))
    return from_jax_variables(jax.tree_util.tree_map(np.asarray, variables["params"]),
                              jax.tree_util.tree_map(np.asarray, variables["constants"]))


@pytest.mark.slow  # ~4 min on 8 CPU cores: 900 train iterations + two evaluations
def test_overfit_moves_m_viou(tmp_path):
    """The port trains from the weights the JAX test starts from (the same
    SEED's draw; the port's own torch.Generator draw is another sample,
    see PERF.md), entering through MODEL.WEIGHT as a reference-named
    torch file, and must pass the JAX test's thresholds."""
    import torch

    weight = str(tmp_path / "jax_init.pth")
    torch.save(_jax_initial_weights(tmp_path), weight)
    out = tl.overfit(str(tmp_path / "run"), device="cpu", extra=["MODEL.WEIGHT", weight])
    print("bf16 metric drift:", {k: round(v, 4) for k, v in sorted(out["drift"].items())})
    tl.check(out)


@pytest.mark.slow  # ~80 s on 8 CPU cores: 900 train iterations + six evaluations
def test_overfit_at_the_ports_draw_evaluates_alike_in_both_packages(tmp_path):
    """The proof from the port's own draw (SEED 42) with chip_smoke.py phase
    10's options (the fused block on its route in training), then the
    trained weights evaluated by both packages: every fp32 metric equal to 4
    digits, and each package's bf16 re-evaluation within the JAX test's
    drift limit of its own fp32 one (vIoU and every tIoU)."""
    from chip_smoke import LEARNING_OPTS

    extra = list(LEARNING_OPTS)
    out = tl.overfit(str(tmp_path / "run"), device="cpu", extra=extra)
    state_dict = out["state"].model.state_dict()
    j32, _ = jax_evaluate(tmp_path / "jax32", state_dict, "float32", extra)
    j16, _ = jax_evaluate(tmp_path / "jax16", state_dict, "bfloat16", extra)
    print("port fp32", out["res"], "bf16 drift", tl.drifts(out["res_bf16"], out["res"]))
    print("JAX bf16 drift", tl.drifts(j16, j32))
    assert j32.keys() == out["res"].keys()
    for k, v in j32.items():
        assert abs(v - out["res"][k]) < 5e-5, (k, v, out["res"][k])
    assert not tl.drift_misses(out["res_bf16"], out["res"]), out["res_bf16"]
    assert not tl.drift_misses(j16, j32), j16


def jax_evaluate(tmp, state_dict, dtype: str, extra=()):
    """The JAX package's run_validation of the port's weights
    (``state_dict``, handed over by ``convert_reference_stcat``) on the
    proof's two clips, at TPU.COMPUTE_DTYPE ``dtype``, with the JAX test's
    config and ``extra`` options. Returns (metrics, rows): per row of each
    forward, its frame mask, pred_sted and pred_boxes as torch tensors."""
    import types

    import numpy as np
    import torch

    import stcat_tpu.train.loop as jloop
    from stcat_tpu.core.logging import setup_logger
    from stcat_tpu.core.mesh import make_mesh
    from stcat_tpu.data.annotations import cache_paths
    from stcat_tpu.data.synthetic import make_synthetic_dataset
    from stcat_tpu.models import STCATNet
    from stcat_tpu.train.convert_reference import convert_reference_stcat

    jcfg = tiny_cfg(["DATA_DIR", str(tmp), "OUTPUT_DIR", os.path.join(str(tmp), "out")]
                    + _jax_test_opts() + list(extra) + ["TPU.COMPUTE_DTYPE", dtype])
    params, consts, unused = convert_reference_stcat(state_dict, jcfg)
    assert unused == set(), unused
    os.makedirs(jcfg.OUTPUT_DIR, exist_ok=True)

    def builder(c, split):  # the JAX test's: evaluate on the trained clips
        if split != "train":
            make_synthetic_dataset(c, "train", n_items=2, n_frames=12, shared_span=True)
            for src, dst in zip(cache_paths(c.DATA_DIR, c.DATASET.NAME, "train"),
                                cache_paths(c.DATA_DIR, c.DATASET.NAME, split)):
                if not os.path.exists(dst):
                    shutil.copy(src, dst)
        return make_synthetic_dataset(c, split, n_items=2, n_frames=12, shared_span=True)

    rows, make_fwd = [], jloop.make_eval_forward

    def keeping(*args, **kwargs):
        fwd = make_fwd(*args, **kwargs)

        def run(*a, **k):
            out = fwd(*a, **k)
            for i, fv in enumerate(np.asarray(out["frame_valid"])):
                rows.append({"frame_valid": torch.from_numpy(fv.astype(bool)), **{
                    n: torch.from_numpy(np.array(out[n][i], np.float32))
                    for n in ("pred_sted", "pred_boxes")}})
            return out
        return run

    state = types.SimpleNamespace(params=params, ema_params=None, constants=consts)
    jloop.make_eval_forward = keeping
    try:
        res = jloop.run_validation(jcfg, STCATNet(jcfg), state, make_mesh(jcfg.TPU.MESH_DATA),
                                   builder, setup_logger("learn", rank=1))
    finally:
        jloop.make_eval_forward = make_fwd
    return res, rows
