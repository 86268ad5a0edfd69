"""The port's train step against the JAX package's, on the CPU.

The whole step at a tiny size: ResNet depths [1, 2, 1, 1] (so layer2 holds
a trainable stride-1 block on the fused-bottleneck route), one encoder and
one RoBERTa layer, two decoder layers (so aux losses exist), every dropout
0, fp32, attention and bottleneck on their kernel routes (the plain versions
on CPU tensors), remat on. The port initialises the model; ``convert_reference_stcat`` hands the
same weights to JAX. Then what only the port can show: gradient
accumulation, dropout streams, the kernel route's dropout rule, frozen parts.
Criterion and optimizer: tests/test_torch_optim.py. Tolerances are stated at
each comparison.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from stcat_tpu.config import to_dict
from stcat_tpu.core.batch import VideoBatch as JBatch, VideoTargets as JTargets
from stcat_tpu.models import STCATNet as JNet
from stcat_tpu.train import criterion as jcrit
from stcat_tpu.train.convert_reference import convert_reference_stcat

from stcat_tpu_torch import config as pconfig
from stcat_tpu_torch.convert import from_jax_variables
from stcat_tpu_torch.core.batch import VideoBatch, VideoTargets
from stcat_tpu_torch.kernels import attention as pka
from stcat_tpu_torch.models import build_model
from stcat_tpu_torch.train import criterion as pcrit
from stcat_tpu_torch.train.optimizer import label_params, make_optimizer
from stcat_tpu_torch.train.step import create_train_state, make_train_step

T = torch.from_numpy

# Under pytest-xdist the workers share the machine's cores: each worker's
# torch gets its share, or the workers' OpenMP pools oversubscribe the cores
# and every test of the run slows down (every worker imports this module
# when it collects, so this holds for all of them).
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

NO_DROPOUT = ["MODEL.STCAT.DROPOUT", 0.0, "MODEL.STCAT.HEAD_DROPOUT", 0.0,
              "MODEL.TEXT_MODEL.DROPOUT", 0.0]
SLICE = ["MODEL.VISION_BACKBONE.DEPTHS", "[1,2,1,1]", "MODEL.STCAT.ENC_LAYERS", 1,
         "MODEL.TEXT_MODEL.LAYERS", 1, "TPU.CONV_IMPL", "pallas",
         "TPU.CONV_STAGES", "[1,2,3,4]", "TPU.REMAT_BACKBONE", "true",
         "SOLVER.WARMUP_PROP", 0.0, "SOLVER.BASE_LR", 1e-3, "SOLVER.TEMP_LR", 1e-3,
         "SOLVER.TEXT_LR", 1e-3, "SOLVER.VIS_BACKBONE_LR", 1e-3, "MODEL.EMA_DECAY", 0.5]
LR = 1e-3


def port_cfg(jcfg):
    return pconfig._merge_dict(pconfig.default_config(), to_dict(jcfg))


def jax_variables(model, jcfg):
    """The port model's weights as JAX {"params", "constants"} trees."""
    params, consts, unused = convert_reference_stcat(model.state_dict(), jcfg)
    assert unused == set()
    return params, consts


def clip_arrays(b=2, t=6, h=64, w=64, l=7, seed=0):
    """A batch whose clips differ in duration, span and box count, with
    padded pixels and tokens, and frame-aligned targets."""
    rng = np.random.RandomState(seed)
    durs, spans = [t, t - 2] + [t] * (b - 2), [(1, 3), (2, 2)] + [(0, t - 1)] * (b - 2)
    frame_valid = np.zeros((b, t), bool)
    actioness = np.zeros((b, t), np.float32)
    temp_bound = np.zeros((b, 2), np.int32)
    for i, (d, (s, e)) in enumerate(zip(durs, spans)):
        frame_valid[i, :d] = True
        actioness[i, s: e + 1] = 1.0
        temp_bound[i] = (s, e)
    box_valid = actioness.astype(bool) & frame_valid
    boxes = np.concatenate([rng.uniform(0.3, 0.6, (b, t, 2)), rng.uniform(0.1, 0.3, (b, t, 2))],
                           -1).astype(np.float32) * box_valid[..., None]
    pixel_valid = np.ones((b, t, h, w), bool)
    pixel_valid[0, :, 48:] = False
    token_valid = np.ones((b, l), bool)
    token_valid[1, 5:] = False
    batch = dict(frames=(rng.randn(b, t, h, w, 3) * 0.5).astype(np.float32),
                 frame_valid=frame_valid, pixel_valid=pixel_valid,
                 token_ids=rng.randint(3, 100, (b, l)).astype(np.int32), token_valid=token_valid)
    targets = dict(boxes=boxes, box_valid=box_valid, actioness=actioness, temp_bound=temp_bound)
    return batch, targets


def port_batch(arrays):
    batch, targets = arrays
    return (VideoBatch(**{k: T(v) for k, v in batch.items()}),
            VideoTargets(**{k: T(v) for k, v in targets.items()}))


# --------------------------------------------------------------------------
# the slice: loss, gradients and two steps against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_slice():
    jcfg = tiny_cfg(NO_DROPOUT + SLICE)
    arrays = clip_arrays()
    model = build_model(port_cfg(jcfg), device="cpu", seed=0)
    params, consts = jax_variables(model, jcfg)
    return jcfg, arrays, model.state_dict(), params, consts


def _jax_inputs(arrays):
    batch, targets = arrays
    return JBatch(**{k: jnp.asarray(v) for k, v in batch.items()}), \
        JTargets(**{k: jnp.asarray(v) for k, v in targets.items()})


def test_train_loss_and_gradients_match_jax(tiny_slice):
    """The port's loss terms and every parameter's gradient against
    jax.value_and_grad of the JAX step's loss, atol 2e-4 / rtol 1e-3 (the
    model-parity tolerance of test_torch_model.py). Frozen-prefix parameters
    get no gradient in the port and a zero one in JAX; so does the RoBERTa
    pooler, whose output (text_cls) the model does not use."""
    jcfg, arrays, sd, params, consts = tiny_slice
    jb, jt = _jax_inputs(arrays)
    weights, s = jcrit.build_weight_dict(jcfg), jcfg.SOLVER
    num_boxes = jnp.maximum(jt.box_valid.sum() / jt.box_valid.shape[0], 1.0)
    jmodel = JNet(jcfg)

    def jloss(p):
        out = jmodel.apply({"params": p, "constants": consts}, jb, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        losses = jcrit.video_stg_loss(out, jt, jb.frame_valid, num_boxes, sigma=s.SIGMA,
                                      eos_coef=s.EOS_COEF)
        return sum(losses[k] * w for k, w in weights.items()), losses

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    cfg = port_cfg(jcfg)
    model = build_model(cfg, device="cpu", seed=0)
    model.load_state_dict(sd)
    model.train()
    batch, targets = port_batch(arrays)
    out = model(batch)
    losses = pcrit.video_stg_loss(out, targets, batch.frame_valid,
                                  torch.tensor(float(num_boxes)), sigma=s.SIGMA,
                                  eos_coef=s.EOS_COEF)
    total = sum(losses[k] * w for k, w in pcrit.build_weight_dict(cfg).items())
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-3, atol=2e-4)
    for k, v in jlosses.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-3, atol=2e-4, err_msg=k)
    expect = from_jax_variables(jax.tree_util.tree_map(np.asarray, jgrads), consts)
    labels = label_params(cfg, model)
    for name, p in model.named_parameters():
        if labels[name] == "frozen" or name.startswith("text_encoder.body.pooler."):
            assert p.grad is None and not expect[name].any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), expect[name].numpy(), rtol=1e-3, atol=2e-4,
                                   err_msg=name)


def test_two_train_steps_match_jax_step(tiny_slice):
    """Params and EMA after two make_train_step steps against the JAX
    make_train_step on a 1-device mesh (AdamW, LR 1e-3, EMA decay 0.5).
    Adam's first steps move each element by about +-LR whatever the
    gradient's size, so an element whose gradient is at noise level can
    move the other way: atol 2.5 x LR. The losses agree at rtol 1e-4."""
    from stcat_tpu.core.mesh import make_mesh, replicate, shard_batch
    from stcat_tpu.train.optimizer import make_optimizer as jmake_opt
    from stcat_tpu.train.step import create_train_state as jcreate, make_train_step as jmake

    jcfg, arrays, sd, params, consts = tiny_slice
    jb, jt = _jax_inputs(arrays)
    tx, _ = jmake_opt(jcfg, params, num_training_steps=10)
    mesh = make_mesh(1)
    jstate = replicate(jcreate(jcfg, {"params": params, "constants": consts}, tx), mesh)
    jstep = jmake(jcfg, JNet(jcfg), tx, mesh)
    jlosses = []
    for _ in range(2):
        jstate, m = jstep(jstate, shard_batch(jb, mesh), shard_batch(jt, mesh),
                          jax.random.PRNGKey(7))
        jlosses.append(float(m["loss"]))

    cfg = port_cfg(jcfg)
    model = build_model(cfg, device="cpu", seed=0)
    model.load_state_dict(sd)
    opt = make_optimizer(cfg, model, num_training_steps=10)
    state = create_train_state(cfg, model, opt)
    step = make_train_step(cfg, model, opt, device="cpu")
    batch, targets = port_batch(arrays)
    losses = [step(state, batch, targets, torch.Generator().manual_seed(7))["loss"].item()
              for _ in range(2)]
    assert state.step == 2 and opt.count == 2
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    want_p = from_jax_variables(jax.tree_util.tree_map(np.asarray, jstate.params), consts)
    want_e = from_jax_variables(jax.tree_util.tree_map(np.asarray, jstate.ema_params), consts)
    labels = label_params(cfg, model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(), atol=2.5 * LR,
                                   err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(), want_e[name].numpy(),
                                   atol=2.5 * LR, err_msg=name)
        if labels[name] == "frozen":
            assert torch.equal(p.detach(), sd[name]), name


# --------------------------------------------------------------------------
# port-only behaviour of the step and the model in training mode
# --------------------------------------------------------------------------

def _raw_batch(cfg, b=2, t=6):
    """A RawVideoBatch with targets from build_raw_batch: two clips with
    different spans and box counts."""
    from stcat_tpu_torch.data.batching import build_raw_batch
    from stcat_tpu_torch.data.tokenize import HashTokenizer
    from stcat_tpu_torch.data.transforms import VideoTransform

    rng = np.random.RandomState(3)
    tf = VideoTransform(64)
    samples = []
    for i, (s, e) in enumerate([(1, 4), (2, 2)][:b]):
        act = np.zeros(t, np.float32)
        act[s: e + 1] = 1.0
        plan, _, text = tf.plan((48, 64), np.zeros((0, 4), np.float32), f"clip {i} walks")
        samples.append({"frames_u8": rng.randint(0, 256, (t, 48, 64, 3), dtype=np.uint8),
                        "plan": plan, "text": text, "actioness": act,
                        "boxes_cxcywh": rng.uniform(0.2, 0.6, (e - s + 1, 4)).astype(np.float32)})
    raw, targets, _ = build_raw_batch(samples, t, HashTokenizer(cfg.MODEL.TEXT_MODEL.VOCAB_SIZE),
                                      cfg.INPUT.MAX_QUERY_LEN)
    return raw, targets


def test_grad_accum_two_equals_one_on_a_raw_batch():
    """TPU.GRAD_ACCUM 2 against 1 from the same weights, on a RawVideoBatch
    whose clips hold 4 and 1 GT boxes (a per-microbatch num_boxes would
    differ). Losses at rtol 1e-5, as tests/test_grad_accum.py holds the JAX
    step; the accumulated (and clipped) gradients the update used at rtol
    1e-4, with an atol of 1e-5 x the largest gradient for elements whose
    true gradient is 0 (the attention key biases) and whose float noise
    differs between the two summation orders. (Adam would turn that noise
    into updates of +-LR, so the gradients are compared, not the params.)"""
    runs = []
    for accum in (1, 2):
        cfg = port_cfg(tiny_cfg(NO_DROPOUT + SLICE + ["TPU.GRAD_ACCUM", accum]))
        model = build_model(cfg, device="cpu", seed=0)
        opt = make_optimizer(cfg, model, num_training_steps=10)
        state = create_train_state(cfg, model, opt)
        raw, targets = _raw_batch(cfg)
        metrics = make_train_step(cfg, model, opt, device="cpu")(state, raw, targets, None)
        assert all(v.dim() == 0 and not v.requires_grad for v in metrics.values())
        runs.append(({k: v.item() for k, v in metrics.items()},
                     {n: p.grad for n, p in model.named_parameters()}))
    (m1, g1), (m2, g2) = runs
    assert set(m1) == set(m2) and "loss" in m1
    for k in m1:
        np.testing.assert_allclose(m2[k], m1[k], rtol=1e-5, atol=1e-6, err_msg=k)
    scale = max(g.abs().max().item() for g in g1.values() if g is not None)
    for name, g in g1.items():
        if g is None:
            assert g2[name] is None, name
            continue
        np.testing.assert_allclose(g2[name].numpy(), g.numpy(), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)


def test_train_step_refuses_what_it_does_not_do():
    """A GRAD_ACCUM that does not divide the batch; a model-parallel size
    that does not divide the heads, refused with the JAX step's own
    ``_validate_tp`` message (the tiny text model has 2 heads, 4 ranks); a
    MODEL_PARALLEL config on a model built without a mesh."""
    from stcat_tpu.core.mesh import make_mesh as jmake_mesh
    from stcat_tpu.train.step import _validate_tp

    from stcat_tpu_torch.core.mesh import make_mesh

    cfg = port_cfg(tiny_cfg(NO_DROPOUT + ["TPU.GRAD_ACCUM", 3]))
    model = build_model(cfg, device="cpu", seed=0)
    opt = make_optimizer(cfg, model, 10)
    step = make_train_step(cfg, model, opt, device="cpu")
    raw, targets = _raw_batch(cfg)
    with pytest.raises(ValueError, match="GRAD_ACCUM"):
        step(create_train_state(cfg, model, opt), raw, targets, None)

    jcfg = tiny_cfg(NO_DROPOUT + ["TPU.MODEL_PARALLEL", 4])
    with pytest.raises(ValueError, match="not divisible") as jax_err:
        _validate_tp(jcfg, jmake_mesh(8, model_parallel=4))
    with pytest.raises(ValueError, match="not divisible") as port_err:
        build_model(port_cfg(jcfg), device="cpu", seed=0,
                    mesh=make_mesh(4, model_parallel=4, world_size=4, rank=0))
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(dataclasses.replace(cfg, TPU=dataclasses.replace(cfg.TPU,
                                                                          MODEL_PARALLEL=2)),
                        model, opt, device="cpu")


def test_dropout_draws_from_the_generator_and_not_in_eval_mode():
    """Same generator seed -> the same masks (identical outputs); another
    seed -> other masks; eval mode draws nothing (the generator's state does
    not move) and matches a dropout-free model."""
    cfg = port_cfg(tiny_cfg(["MODEL.STCAT.DROPOUT", 0.2]))
    model = build_model(cfg, device="cpu", seed=0)
    batch, _ = port_batch(clip_arrays())
    model.train()
    with torch.no_grad():
        outs = [model(batch, generator=torch.Generator().manual_seed(s))["pred_sted"]
                for s in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    model.eval()
    g = torch.Generator().manual_seed(5)
    before = g.get_state()
    with torch.no_grad():
        out = model(batch, generator=g)["pred_sted"]
    assert torch.equal(g.get_state(), before)
    plain = build_model(port_cfg(tiny_cfg(NO_DROPOUT)), device="cpu", seed=0)
    with torch.no_grad():
        torch.testing.assert_close(out, plain(batch)["pred_sted"], rtol=0, atol=0)


def test_training_dropout_needs_a_generator():
    """A training forward that would draw dropout masks refuses to draw them
    from torch's global RNG; without dropout, or in eval mode, none is needed."""
    batch, _ = port_batch(clip_arrays())
    model = build_model(port_cfg(tiny_cfg(["MODEL.STCAT.DROPOUT", 0.2])), device="cpu", seed=0)
    with torch.no_grad():
        model.eval()(batch)
        with pytest.raises(ValueError, match="Generator"):
            model.train()(batch)
        build_model(port_cfg(tiny_cfg(NO_DROPOUT)), device="cpu", seed=0).train()(batch)


def test_attention_kernel_route_only_without_drawn_dropout(monkeypatch):
    """The kernel route (kattn.flash_attention) takes every eligible call in
    eval mode and with DROPOUT 0; with attention dropout drawn in training
    it takes none, as the JAX package's attention_core requires."""
    calls = []
    real = pka.flash_attention
    monkeypatch.setattr(pka, "flash_attention", lambda *a: calls.append(1) or real(*a))
    batch, _ = port_batch(clip_arrays())
    counts = {}
    for rate, train in ((0.0, True), (0.2, False), (0.2, True)):
        cfg = port_cfg(tiny_cfg(["MODEL.STCAT.DROPOUT", rate]))
        model = build_model(cfg, device="cpu", seed=0).train(train)
        calls.clear()
        with torch.no_grad():
            model(batch, generator=torch.Generator().manual_seed(0))
        counts[(rate, train)] = len(calls)
    # 2 encoder layers x (spatial + temporal) + 2 spatial + 2 time decoder cross
    assert counts == {(0.0, True): 8, (0.2, False): 8, (0.2, True): 0}


@pytest.mark.parametrize("extra,none_prefixes,some_prefixes", [
    ([], ("vis_encoder.0.body.conv1.", "vis_encoder.0.body.layer1."),
     ("vis_encoder.0.body.layer2.", "text_encoder.body.", "input_proj.")),
    (["MODEL.VISION_BACKBONE.FREEZE", "true"], ("vis_encoder.0.body.",), ("input_proj.",)),
    (["MODEL.TEXT_MODEL.FREEZE", "true"], ("text_encoder.body.",), ("text_encoder.resizer.",)),
])
def test_frozen_parts_get_no_gradient(extra, none_prefixes, some_prefixes):
    cfg = port_cfg(tiny_cfg(NO_DROPOUT + SLICE + extra))
    model = build_model(cfg, device="cpu", seed=0).train()
    batch, targets = port_batch(clip_arrays())
    out = model(batch)
    pcrit.video_stg_loss(out, targets, batch.frame_valid, torch.tensor(1.0))["loss_bbox"] \
        .backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for prefix in none_prefixes:
        hit = [n for n in grads if n.startswith(prefix)]
        assert hit and all(grads[n] is None for n in hit), prefix
    for prefix in some_prefixes:
        hit = [n for n in grads if n.startswith(prefix)]
        assert hit and any(grads[n] is not None and grads[n].abs().sum() > 0 for n in hit), prefix
