"""The port's criterion and optimizer against the JAX package's, on the CPU.

``video_stg_loss`` and its gradients on identical numpy predictions; the box
and sted-target ops; ``label_params`` against the JAX labels (each JAX leaf
filled with its group's code and mapped through ``from_jax_variables``); and
``make_optimizer`` against the JAX optax chain for each of the four cores.
Tolerances are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from stcat_tpu.core.batch import VideoTargets as JTargets
from stcat_tpu.train import criterion as jcrit
from test_torch_train import clip_arrays, jax_variables, port_cfg

from stcat_tpu_torch.convert import from_jax_variables
from stcat_tpu_torch.core.batch import VideoTargets
from stcat_tpu_torch.models import build_model
from stcat_tpu_torch.train import criterion as pcrit
from stcat_tpu_torch.train.optimizer import label_params, make_optimizer

T = torch.from_numpy


# --------------------------------------------------------------------------
# criterion
# --------------------------------------------------------------------------

def _predictions(rng, b, t, aux):
    def one():
        w = rng.uniform(0.0, 1.0, (b, t, t)).astype(np.float32)
        return {"pred_boxes": rng.uniform(0.2, 0.8, (b, t, 4)).astype(np.float32),
                "pred_sted": (rng.randn(b, t, 2) * 2).astype(np.float32),
                "weights": w / w.sum(-1, keepdims=True),
                "pred_actioness": rng.randn(b, t, 1).astype(np.float32)}
    out = one()
    out["aux_outputs"] = [one() for _ in range(aux)]
    return out


def test_video_stg_loss_and_its_gradients_match_jax():
    """Every loss term (aux replicas included) and the gradient of the
    weighted total w.r.t. every prediction, at fp32 summation-order
    tolerance (rtol 1e-5, atol 1e-6)."""
    rng = np.random.RandomState(0)
    b, t = 3, 8
    _, targets = clip_arrays(b=b, t=t)
    time_mask = targets["box_valid"] | np.asarray([[True] * t, [True] * 6 + [False] * 2,
                                                   [True] * t])
    preds = _predictions(rng, b, t, aux=2)
    jcfg = tiny_cfg(["MODEL.STCAT.DEC_LAYERS", 3])
    weights = jcrit.build_weight_dict(jcfg)
    assert pcrit.build_weight_dict(port_cfg(jcfg)) == weights
    kw = dict(sigma=2.0, eos_coef=0.3)
    num_boxes = max(targets["box_valid"].sum() / b, 1.0)

    def jtotal(p):
        losses = jcrit.video_stg_loss(p, JTargets(**targets), jnp.asarray(time_mask),
                                      jnp.float32(num_boxes), **kw)
        return sum(losses[k] * w for k, w in weights.items()), losses

    (jt, jl), jg = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, preds))
    tp = jax.tree_util.tree_map(lambda a: T(a).requires_grad_(), preds)
    pl = pcrit.video_stg_loss(tp, VideoTargets(**{k: T(v) for k, v in targets.items()}),
                              T(time_mask), torch.tensor(num_boxes, dtype=torch.float32), **kw)
    assert set(pl) == set(jl) and len(pl) == 15
    for k in jl:
        np.testing.assert_allclose(pl[k].item(), float(jl[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    sum(pl[k] * w for k, w in weights.items()).backward()
    for (path, g), p in zip(jax.tree_util.tree_leaves_with_path(jg),
                            jax.tree_util.tree_leaves(tp)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_box_ops_and_sted_target_match_jax():
    from stcat_tpu.ops import boxes as jboxes, sted as jsted
    from stcat_tpu_torch.ops import boxes as pboxes, sted as psted

    rng = np.random.RandomState(1)
    a = rng.uniform(0, 1, (5, 7, 4)).astype(np.float32)
    b = rng.uniform(0, 1, (5, 7, 4)).astype(np.float32)
    a[0, 0] = b[0, 0]  # identical boxes
    xa, xb = jboxes.box_cxcywh_to_xyxy(a), jboxes.box_cxcywh_to_xyxy(b)
    for name in ("box_iou_pairwise", "generalized_box_iou_pairwise"):
        ours = getattr(pboxes, name)(T(np.array(xa)), T(np.array(xb)))
        theirs = getattr(jboxes, name)(xa, xb)
        for o, t in zip(*((ours, theirs) if isinstance(ours, tuple) else ((ours,), (theirs,)))):
            np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=1e-6, atol=1e-6)
    idx = np.asarray([0, 3, 9], np.int32)
    mask = np.ones((3, 10), bool)
    mask[1, 6:] = False
    for m in (None, mask):
        ours = psted.gaussian_sted_target(10, T(idx), 2.0, None if m is None else T(m))
        theirs = jsted.gaussian_sted_target(10, jnp.asarray(idx), 2.0,
                                            None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

GROUP_CODE = {"rest": 0.0, "vis": 1.0, "text": 2.0, "temp": 3.0, "frozen": 4.0}


@pytest.mark.parametrize("extra", [
    [],
    ["MODEL.TEXT_MODEL.FREEZE", "true"],
    ["MODEL.VISION_BACKBONE.FREEZE", "true"],
    ["SOLVER.VIS_BACKBONE_LR", 0.0],
    ["MODEL.VISION_BACKBONE.POS_ENC", "learned", "MODEL.STCAT.USE_LEARN_TIME_EMBED", "true",
     "MODEL.STCAT.FROM_SCRATCH", "false"],
])
def test_label_params_match_jax(extra):
    """Each JAX leaf filled with its group's code, mapped through
    from_jax_variables, lands on a port parameter of the same group."""
    from stcat_tpu.train.optimizer import label_params as jlabel

    jcfg = tiny_cfg(extra)
    model = build_model(port_cfg(jcfg), device="cpu", seed=0)
    params, consts = jax_variables(model, jcfg)
    coded = jax.tree_util.tree_map(lambda lbl, leaf: np.full(np.shape(leaf), GROUP_CODE[lbl],
                                                             np.float32),
                                   jlabel(jcfg, params), params)
    mapped = from_jax_variables(coded, consts)
    ours = label_params(port_cfg(jcfg), model)
    assert set(ours) == {n for n, _ in model.named_parameters()}
    for name, label in ours.items():
        assert torch.all(mapped[name] == GROUP_CODE[label]), (name, label)
    assert {"rest", "vis", "text", "temp", "frozen"} >= set(ours.values())


# port parameter name -> JAX path, one or two per group (frozen included)
OPT_PARAMS = {
    "vis_encoder.0.body.conv1.weight": ("vis_encoder", "stem_conv", "kernel"),
    "vis_encoder.0.body.layer1.0.conv1.weight": ("vis_encoder", "layer1_0", "conv1", "kernel"),
    "vis_encoder.0.body.layer3.0.conv2.weight": ("vis_encoder", "layer3_0", "conv2", "kernel"),
    "vis_encoder.1.row_embed.weight": ("pos_encoding", "learned", "row_embed"),
    "text_encoder.body.encoder.layer.0.output.dense.weight":
        ("text_encoder", "roberta", "layer_0", "output", "kernel"),
    "text_encoder.resizer.fc.weight": ("text_encoder", "resizer", "fc", "kernel"),
    "ground_decoder.temp_decoder.layers.0.linear1.weight":
        ("temp_decoder", "layer_0", "linear1", "kernel"),
    "bbox_embed.layers.0.weight": ("bbox_embed", "layer_0", "kernel"),
}


def _named_module(arrays):
    """An nn.Module whose named_parameters() are the dotted names given."""
    root = torch.nn.Module()
    for name, value in arrays.items():
        *path, leaf = name.split(".")
        mod = root
        for part in path:
            if part not in mod._modules:
                mod.add_module(part, torch.nn.Module())
            mod = mod._modules[part]
        mod.register_parameter(leaf, torch.nn.Parameter(T(value.copy())))
    return root


def _at(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def _jax_tree(arrays):
    tree = {}
    for name, value in arrays.items():
        *path, leaf = OPT_PARAMS[name]
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value)
    return tree


@pytest.mark.parametrize("name", ["adamw", "adam", "rmsprop", "sgd"])
def test_optimizer_matches_jax_over_three_steps(name):
    """make_optimizer's updates against the JAX optax chain fed the same
    gradients for 3 steps, on parameters named like the model's groups
    (tests/test_train_step.py holds optax against torch.optim the same way):
    warmup, an LR drop, per-group LRs, clipping over the trainable parameters
    only (frozen gradients are huge and must not count), weight decay. The
    labels of both sides agree. rtol 2e-5 / atol 2e-6, as there."""
    from stcat_tpu.train.optimizer import make_optimizer as jmake

    jcfg = tiny_cfg(["SOLVER.OPTIMIZER", name, "SOLVER.BASE_LR", 1e-2,
                     "SOLVER.VIS_BACKBONE_LR", 1e-3, "SOLVER.TEXT_LR", 5e-3,
                     "SOLVER.TEMP_LR", 2e-2, "SOLVER.WEIGHT_DECAY", 1e-2,
                     "SOLVER.MAX_GRAD_NORM", 0.1,
                     "SOLVER.SCHEDULE.TYPE", "multistep_with_warmup_all",
                     "SOLVER.SCHEDULE.DROP_STEP", "[1,5]", "SOLVER.MAX_EPOCH", 3,
                     "SOLVER.WARMUP_PROP", 0.34])
    rng = np.random.RandomState(0)
    arrays = {n: rng.randn(7 + i, 3).astype(np.float32) for i, n in enumerate(OPT_PARAMS)}
    params = _jax_tree(arrays)
    tx, labels = jmake(jcfg, params, num_training_steps=6)
    state = tx.init(params)
    model = _named_module(arrays)
    opt = make_optimizer(port_cfg(jcfg), model, num_training_steps=6)
    for n, path in OPT_PARAMS.items():
        assert opt.labels[n] == _at(labels, path), n
    named = dict(model.named_parameters())
    for step in range(3):
        rng = np.random.RandomState(100 + step)
        grads = {n: rng.randn(*a.shape).astype(np.float32)
                 * (1e6 if opt.labels[n] == "frozen" else 1.0) for n, a in arrays.items()}
        updates, state = tx.update(_jax_tree(grads), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        opt.zero_grad()
        for n, g in grads.items():
            named[n].grad = T(g)
        opt.step()
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(_at(params, OPT_PARAMS[n])),
                                   rtol=2e-5, atol=2e-6, err_msg=n)


@pytest.mark.parametrize("stype", ["multistep_with_warmup", "multistep_with_warmup_all",
                                   "linear_with_warmup"])
def test_current_lrs_match_jax(stype):
    """Per-group learning rates over a run, rtol 1e-6 (JAX computes them in
    fp32)."""
    from stcat_tpu.train.optimizer import current_lrs as jlrs
    from stcat_tpu_torch.train.optimizer import current_lrs

    jcfg = tiny_cfg(["SOLVER.SCHEDULE.TYPE", stype, "SOLVER.SCHEDULE.DROP_STEP", "[8,10]",
                     "SOLVER.MAX_EPOCH", 20, "SOLVER.WARMUP_PROP", 0.05, "SOLVER.BASE_LR", 1e-4,
                     "SOLVER.VIS_BACKBONE_LR", 1e-5, "SOLVER.TEXT_LR", 5e-5,
                     "SOLVER.TEMP_LR", 2e-4])
    ours, theirs = current_lrs(port_cfg(jcfg), 1000), jlrs(jcfg, 1000)
    for step in (0, 1, 25, 49, 50, 51, 399, 400, 449, 500, 550, 999, 1000):
        a, b = ours(step), theirs(step)
        assert set(a) == set(b)
        for g in a:
            np.testing.assert_allclose(a[g], b[g], rtol=1e-6, atol=0, err_msg=f"{g} @ {step}")


@pytest.mark.parametrize("name", ["adamw", "adam", "rmsprop", "sgd"])
def test_optimizer_state_dict_resumes_bitwise(name):
    """GroupedOptimizer.state_dict() through torch.save / torch.load into a
    fresh optimizer over a fresh module holding the same weights: 3 steps,
    save, load, 2 more steps equals 5 uninterrupted steps bitwise (weights,
    moments, count), with a warmup so that the LR depends on ``count``. A
    state of other groups is refused."""
    import io

    cfg = port_cfg(tiny_cfg(["SOLVER.OPTIMIZER", name, "SOLVER.BASE_LR", 1e-2,
                             "SOLVER.WEIGHT_DECAY", 1e-2, "SOLVER.WARMUP_PROP", 0.5,
                             "SOLVER.MAX_GRAD_NORM", 0.1]))
    rng = np.random.RandomState(0)
    arrays = {n: rng.randn(7 + i, 3).astype(np.float32) for i, n in enumerate(OPT_PARAMS)}
    grads = [{n: np.random.RandomState(100 + s).randn(*a.shape).astype(np.float32)
              for n, a in arrays.items()} for s in range(5)]

    def run(model, opt, steps):  # copies: the clip scales the gradients in place
        named = dict(model.named_parameters())
        for s in steps:
            opt.zero_grad()
            for n, g in grads[s].items():
                named[n].grad = torch.tensor(g)
            opt.step()

    def fresh():  # _named_module's parameters share the arrays' memory
        return _named_module({n: a.copy() for n, a in arrays.items()})

    whole = fresh()
    whole_opt = make_optimizer(cfg, whole, num_training_steps=6)
    run(whole, whole_opt, range(5))

    first = fresh()
    first_opt = make_optimizer(cfg, first, num_training_steps=6)
    run(first, first_opt, range(3))
    buf = io.BytesIO()
    torch.save({"model": first.state_dict(), "optimizer": first_opt.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    resumed = fresh()
    resumed.load_state_dict(saved["model"])
    resumed_opt = make_optimizer(cfg, resumed, num_training_steps=6)
    resumed_opt.load_state_dict(saved["optimizer"])
    assert resumed_opt.count == 3
    run(resumed, resumed_opt, range(3, 5))

    assert resumed_opt.count == whole_opt.count == 5
    for (n, p), q in zip(whole.named_parameters(), resumed.parameters()):
        assert torch.equal(p, q), n
    a, b = whole_opt.state_dict()["core"]["state"], resumed_opt.state_dict()["core"]["state"]
    assert a.keys() == b.keys()
    for i in a:
        for k in a[i]:
            assert torch.equal(torch.as_tensor(a[i][k]), torch.as_tensor(b[i][k])), (i, k)
    other = dict(saved["optimizer"], groups=["rest"])
    with pytest.raises(ValueError, match="groups"):
        resumed_opt.load_state_dict(other)
