"""The learning proof (tests/test_learning.py) on the port.

tests/torch_learning.py runs it (torch only, so chip_smoke.py runs it on the
card too). Here its config is held to the JAX test's, read from that test's
source, and the proof itself runs on the CPU (``slow``: 900 iterations).
"""

import ast
import os

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
