"""Port modules against their JAX counterparts, at small sizes on the CPU.

Each JAX module is initialised by flax, its variables go through
``stcat_tpu_torch.convert`` into the port module, and both run on the same
numpy inputs made from a seed. Tolerance: fp32 on both sides, atol 2e-5 for
single layers and 1e-4 for stacks (summation order only, grown over depth),
unless stated at the assertion.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg

import stcat_tpu_torch.convert as pconv
from stcat_tpu_torch.core.batch import RawVideoBatch as PRaw

T = torch.from_numpy


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state_dict(section, *args):
    w = pconv.Writer()
    section(w, *args)
    return w.sd


def _mlp_state_dict(node):
    sd = _state_dict(lambda w, n: w.mlp("mlp", n), node)
    return {k[len("mlp."):]: v for k, v in sd.items()}


def _close(ours, theirs, atol=2e-5, rtol=0.0):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), atol=atol, rtol=rtol)


# --------------------------------------------------------------------------
# embeddings, position encodings, small ops
# --------------------------------------------------------------------------

def _pixel_mask(seed=0):
    mask = np.ones((2, 3, 9, 11), bool)
    mask[0, :, 6:, :] = False
    mask[1, :, :, 7:] = False
    return mask


@pytest.mark.parametrize("kind", ["sine", "sineHW", "learned"])
def test_position_encoding_2d(kind):
    from stcat_tpu.models.position2d import PositionEncoding2D as JPos
    from stcat_tpu_torch.models.position2d import PositionEncoding2D as PPos

    mask = _pixel_mask()
    jmod = JPos(kind=kind, num_pos_feats=16)
    var = jmod.init(jax.random.PRNGKey(0), jnp.asarray(mask))
    ref = jmod.apply(var, jnp.asarray(mask))
    ours = PPos(kind, 16)
    if kind == "learned":
        learned = var["params"]["learned"]
        ours.load_state_dict({"row_embed.weight": T(np.array(learned["row_embed"])),
                              "col_embed.weight": T(np.array(learned["col_embed"]))})
    _close(ours(T(mask)), ref, atol=1e-5)  # sin/cos of arguments up to 2*pi


def test_time_and_anchor_sine_embeddings():
    from stcat_tpu.ops import embeddings as je
    from stcat_tpu.ops.misc import inverse_sigmoid as j_inv
    from stcat_tpu_torch.ops import embeddings as pe
    from stcat_tpu_torch.ops.misc import inverse_sigmoid as p_inv

    _close(pe.sine_time_embedding(33, 64), je.sine_time_embedding(33, 64), atol=1e-5)
    rng = np.random.RandomState(0)
    for n in (2, 4):
        pos = rng.uniform(0, 1, (3, 5, n)).astype(np.float32)
        _close(pe.anchor_sine_embedding(T(pos), 32), je.anchor_sine_embedding(jnp.asarray(pos), 32),
               atol=1e-5)
    x = np.concatenate([rng.uniform(-0.5, 1.5, 50), [0.0, 1.0, 1e-4]]).astype(np.float32)
    _close(p_inv(T(x)), j_inv(jnp.asarray(x)), atol=1e-5)


def test_downsample_mask():
    from stcat_tpu.models.resnet import downsample_mask as j_down
    from stcat_tpu_torch.models.resnet import downsample_mask as p_down

    mask = _pixel_mask()
    for out_hw in ((3, 4), (2, 2), (9, 11)):
        np.testing.assert_array_equal(p_down(T(mask), out_hw).numpy(),
                                      np.asarray(j_down(jnp.asarray(mask), out_hw)))


# --------------------------------------------------------------------------
# ResNet
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,conv_impl,dc5", [
    ("resnet50", "xla", False),
    ("resnet50", "pallas", False),   # fused blocks: the kernel's plain version
    ("resnet50", "pallas", True),    # DC5: dilated layer4 through the fused path
    ("resnet50-gn", "pallas", False),  # GroupNorm: never fused
])
def test_resnet(name, conv_impl, dc5):
    from stcat_tpu.models.resnet import build_resnet as j_build
    from stcat_tpu_torch.models.resnet import build_resnet as p_build

    rng = np.random.RandomState(0)
    x = (rng.randn(2, 64, 64, 3) * 0.5).astype(np.float32)
    jmodel, _ = j_build(name, dc5, depths=(1, 1, 1, 1), frozen_stages=0)
    var = _np_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    consts = var.get("constants", {})
    # non-trivial frozen statistics, so the fold into the fused weights shows
    consts = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), consts)
    ref = jax.jit(jmodel.apply)({"params": var["params"], "constants": consts}, jnp.asarray(x))

    ours = p_build(name, dc5, depths=(1, 1, 1, 1), conv_impl=conv_impl).eval()
    ours.load_state_dict(_state_dict(pconv.backbone, var["params"], consts), strict=True)
    with torch.no_grad():
        out = ours(T(x))
    scale = float(np.abs(np.asarray(ref)).max())
    _close(out, ref, atol=1e-5 * max(1.0, scale))  # relative to the activations' size


# --------------------------------------------------------------------------
# text encoder
# --------------------------------------------------------------------------

def test_roberta_text_encoder():
    from stcat_tpu.models.roberta import RobertaConfig as JCfg, TextEncoder as JText
    from stcat_tpu_torch.models.roberta import RobertaConfig as PCfg, TextEncoder as PText

    kw = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
              intermediate_size=64, max_position_embeddings=64)
    rng = np.random.RandomState(0)
    ids = rng.randint(3, 128, (3, 9)).astype(np.int32)
    valid = np.ones((3, 9), bool)
    valid[1, 6:] = False
    valid[2, 3:] = False
    jmod = JText(d_model=48, cfg=JCfg(**kw))
    var = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(0), ids, valid))
    ref_feats, ref_cls = jax.jit(jmod.apply)(var, ids, valid)

    ours = PText(48, PCfg(**kw)).eval()
    p = var["params"]
    sd = _state_dict(pconv.roberta, p["roberta"], "body.")
    w = pconv.Writer()
    w.dense("resizer.fc", p["resizer"]["fc"])
    w.norm("resizer.layer_norm", p["resizer"]["ln"])
    ours.load_state_dict({**sd, **w.sd}, strict=True)
    with torch.no_grad():
        feats, cls = ours(T(ids), T(valid))
    _close(feats, ref_feats, atol=1e-4)
    _close(cls, ref_cls, atol=1e-4)


# --------------------------------------------------------------------------
# cross-modal encoder and decoders
# --------------------------------------------------------------------------

D, HEADS, FFN, LAYERS = 64, 4, 128, 2


def _encoder_inputs(seed=0, b=2, t=5, hf=3, wf=4, l=6):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    vis_valid = np.ones((b, t, hf, wf), bool)
    vis_valid[1, :, 2:, :] = False
    text_valid = np.ones((b, l), bool)
    text_valid[0, 4:] = False
    frame_valid = np.ones((b, t), bool)
    frame_valid[1, 3:] = False
    return (f(b, t, hf, wf, D), vis_valid, f(b, t, hf, wf, D), f(b, l, D), text_valid,
            frame_valid)


@pytest.mark.parametrize("impl,learned", [("xla", False), ("pallas", False), ("pallas", True)])
def test_cross_modal_encoder(impl, learned):
    from stcat_tpu.models.encoder import CrossModalEncoder as JEnc
    from stcat_tpu_torch.models.encoder import CrossModalEncoder as PEnc

    args = _encoder_inputs()
    jmod = JEnc(D, HEADS, FFN, LAYERS, max_video_len=32, dropout=0.0,
                learned_time_embed=learned)
    var = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(0), *args))
    refs = jax.jit(jmod.apply)(var, *args)
    ours = PEnc(D, HEADS, FFN, LAYERS, 32, learned, impl=impl).eval()
    ours.load_state_dict(_state_dict(pconv.encoder, var["params"]), strict=True)
    with torch.no_grad():
        outs = ours(*map(T, args))
    for o, r in zip(outs, refs):
        if o.dtype == torch.bool:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        else:
            _close(o, r, atol=1e-4)


def _decoder_inputs(seed=1, b=2, t=5, m=7):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mem_valid = np.ones((b, t, m), bool)
    mem_valid[0, :, 5:] = False
    mem_valid[1, 2, :] = False          # a frame with no attendable memory
    frame_valid = np.ones((b, t), bool)
    frame_valid[1, 4:] = False
    return rng, f, mem_valid, frame_valid


@pytest.mark.parametrize("from_scratch", [True, False])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_spatial_decoder(from_scratch, impl):
    from stcat_tpu.models.decoder import MLP as JMLP, SpatialDecoder as JDec
    from stcat_tpu_torch.models.decoder import MLP as PMLP, SpatialDecoder as PDec

    rng, f, mem_valid, frame_valid = _decoder_inputs()
    b, t, m = mem_valid.shape
    anchors = rng.uniform(0.1, 0.9, (b, t, 4)).astype(np.float32)
    args = (anchors, f(b, t, m, D), mem_valid, f(b, t, m, D), f(b, t, D), frame_valid)
    jmod = JDec(D, HEADS, FFN, LAYERS, bbox_embed=JMLP(D, 4, 3), dropout=0.0,
                from_scratch=from_scratch)
    var = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(0), *args))
    ref_hs, ref_refs = jax.jit(jmod.apply)(var, *args)

    ours = PDec(D, HEADS, FFN, LAYERS, from_scratch=from_scratch, impl=impl).eval()
    ours.load_state_dict(_state_dict(pconv.spatial_decoder, var["params"]), strict=True)
    bbox = PMLP(D, D, 4, 3)
    bbox.load_state_dict(_mlp_state_dict(var["params"]["bbox_embed"]), strict=True)
    with torch.no_grad():
        hs, refs = ours(*map(T, args), bbox_embed=bbox)
    _close(hs, ref_hs, atol=1e-4)
    _close(refs, ref_refs, atol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_time_decoder(impl):
    from stcat_tpu.models.decoder import TimeDecoder as JDec
    from stcat_tpu_torch.models.decoder import TimeDecoder as PDec

    _, f, mem_valid, frame_valid = _decoder_inputs(seed=2)
    b, t, m = mem_valid.shape
    args = (f(b, t, m, D), mem_valid, f(b, t, m, D), f(b, t, D), f(b, t, D), frame_valid)
    jmod = JDec(D, HEADS, FFN, LAYERS, dropout=0.0)
    var = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(0), *args))
    ref_states, ref_weights = jax.jit(jmod.apply)(var, *args)
    ours = PDec(D, HEADS, FFN, LAYERS, impl=impl).eval()
    ours.load_state_dict(_state_dict(pconv.time_decoder, var["params"]), strict=True)
    with torch.no_grad():
        states, weights = ours(*map(T, args))
    _close(states, ref_states, atol=1e-4)
    _close(weights, ref_weights, atol=1e-5)


def test_template_generator_and_mlp():
    from stcat_tpu.models.decoder import MLP as JMLP, TemplateGenerator as JTpl
    from stcat_tpu_torch.models.decoder import MLP as PMLP, TemplateGenerator as PTpl

    rng = np.random.RandomState(3)
    frames_cls = rng.randn(2, 5, D).astype(np.float32)
    videos_cls = rng.randn(2, D).astype(np.float32)
    jt = JTpl(D, 4)
    var = _np_tree(jt.init(jax.random.PRNGKey(0), frames_cls, videos_cls))
    ref_anchor, ref_content = jt.apply(var, frames_cls, videos_cls)
    ours = PTpl(D, 4)
    w = pconv.Writer()
    for n, node in var["params"].items():
        w.dense(n, node)
    ours.load_state_dict(w.sd, strict=True)
    anchor, content = ours(T(frames_cls), T(videos_cls))
    _close(anchor, ref_anchor)
    _close(content, ref_content)

    jm = JMLP(D, 2, 2)
    var = _np_tree(jm.init(jax.random.PRNGKey(1), frames_cls))
    pm = PMLP(D, D, 2, 2)
    pm.load_state_dict(_mlp_state_dict(var["params"]), strict=True)
    _close(pm(T(frames_cls)), jm.apply(var, frames_cls))


# --------------------------------------------------------------------------
# preprocess, postprocess, sted decode
# --------------------------------------------------------------------------

def _raw_samples(transform_plan, flip_lane=1):
    rng = np.random.RandomState(4)
    sizes = [(5, 48, 64), (3, 40, 30), (4, 50, 70)]
    samples = []
    for i, (t, h, w) in enumerate(sizes):
        plan = transform_plan((h, w))
        if i == flip_lane:
            plan = dataclasses.replace(plan, flip=True)
        samples.append({
            "frames_u8": rng.randint(0, 256, (t, h, w, 3), dtype=np.uint8), "plan": plan,
            "text": f"clip {i} moves left", "item_id": i, "frame_ids": list(range(t)),
            "ori_size": (h, w), "actioness": np.ones(t, np.float32),
            "boxes_cxcywh": np.zeros((t, 4), np.float32),
        })
    return samples


def test_raw_batch_and_rgb_preprocess_with_flipped_lane():
    from stcat_tpu.core.batch import RawVideoBatch as JRaw
    from stcat_tpu.data.batching import build_raw_batch as j_build
    from stcat_tpu.data.tokenize import HashTokenizer as JTok
    from stcat_tpu.data.transforms import VideoTransform as JTransform
    from stcat_tpu.ops.preprocess import preprocess as j_pre
    from stcat_tpu_torch.data.batching import build_raw_batch as p_build
    from stcat_tpu_torch.data.tokenize import HashTokenizer as PTok
    from stcat_tpu_torch.data.transforms import VideoTransform as PTransform
    from stcat_tpu_torch.ops.preprocess import preprocess as p_pre

    jt, pt = JTransform(64, is_train=False), PTransform(64)
    empty = np.zeros((0, 4), np.float32)
    jplan = lambda hw: jt.plan(hw, empty, "", np.random.default_rng(0))[0]
    pplan = lambda hw: pt.plan(hw, empty, "")[0]
    for hw in ((48, 64), (40, 30), (50, 70), (64, 64)):
        assert dataclasses.asdict(pplan(hw)) == dataclasses.asdict(jplan(hw))

    jraw, _, jmeta = j_build(_raw_samples(jplan), 8, JTok(128), 10)
    praw, pmeta = p_build(_raw_samples(pplan), 8, PTok(128), 10)
    for f in dataclasses.fields(PRaw):
        a, b = getattr(praw, f.name), getattr(jraw, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
    assert pmeta == [{k: m[k] for k in pmeta[0]} for m in jmeta]

    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    ref = j_pre(JRaw(**{f.name: getattr(jraw, f.name) for f in dataclasses.fields(PRaw)}),
                mean, std)
    tensors = {f.name: getattr(praw, f.name) for f in dataclasses.fields(PRaw)}
    ours = p_pre(PRaw(**{k: (T(v) if isinstance(v, np.ndarray) else v)
                         for k, v in tensors.items()}), mean, std)
    _close(ours.frames, ref.frames, atol=1e-5)  # normalized pixels ~[-2.1, 2.7]
    for name in ("pixel_valid", "frame_valid", "token_ids", "token_valid"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))


def test_postprocess_and_decode_sted():
    from stcat_tpu.models.postprocess import postprocess as j_post
    from stcat_tpu_torch.models.postprocess import postprocess as p_post

    rng = np.random.RandomState(5)
    b, t = 4, 9
    boxes = rng.uniform(0, 1, (b, t, 4)).astype(np.float32)
    sted = (rng.randn(b, t, 2) * 3).astype(np.float32)
    sizes = np.asarray([[240, 320], [480, 640], [100, 50], [33, 77]], np.int32)
    mask = np.ones((b, t), bool)
    mask[1, 5:] = False
    mask[2, 2:] = False
    mask[3, 1:] = False  # one valid frame: no s < e pair
    ref = j_post(jnp.asarray(boxes), jnp.asarray(sted), jnp.asarray(sizes), jnp.asarray(mask))
    ours = p_post(T(boxes), T(sted), T(sizes), T(mask))
    _close(ours[0], ref[0], atol=1e-4)  # pixels up to 640
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))


# --------------------------------------------------------------------------
# host side: tokenizer, transform plan, two-stream merge, config
# --------------------------------------------------------------------------

def test_hash_tokenizer_and_resize_plan():
    from stcat_tpu.data.tokenize import HashTokenizer as JTok
    from stcat_tpu.data.transforms import resize_keep_ratio as j_resize
    from stcat_tpu_torch.data.tokenize import HashTokenizer as PTok
    from stcat_tpu_torch.data.transforms import resize_keep_ratio as p_resize

    texts = ["A man walks LEFT", "", "one two three four five six seven eight nine ten"]
    for a, b in zip(PTok(50265)(texts, 8), JTok(50265)(texts, 8)):
        np.testing.assert_array_equal(a, b)
    for hw in ((240, 320), (320, 240), (448, 448), (100, 2000), (1080, 1920)):
        for size, cap in ((448, 720), (416, None), (64, 720)):
            assert p_resize(size, hw, cap) == j_resize(size, hw, cap)


def test_two_stream_merge():
    from stcat_tpu.eval import engine as je
    from stcat_tpu_torch.eval import engine as pe

    rng = np.random.RandomState(6)
    boxes = rng.uniform(0, 100, (4, 4, 4)).astype(np.float32)
    s_idx, e_idx = np.array([0, 1, 0, 1]), np.array([3, 2, 1, 2])
    fv = np.ones((4, 4), bool)
    fv[1, 3:] = False
    fv[3, 3:] = False
    m1 = [{"item_id": 0, "frame_ids": [0, 2, 4, 6]}, {"item_id": 1, "frame_ids": [0, 4, 8]}]
    m2 = [{"item_id": 0, "frame_ids": [1, 3, 5, 7]}, {"item_id": 1, "frame_ids": [2, 6, 10]}]
    assert pe.merge_two_streams(boxes, s_idx, e_idx, fv, m1, m2) == \
        je.merge_two_streams(boxes, s_idx, e_idx, fv, m1, m2)
    pad = [m1[0], {**m1[1], "pad": True}]
    assert pe._decode_rows(boxes, s_idx, e_idx, fv, pad, 0) == \
        je._decode_rows(boxes, s_idx, e_idx, fv, pad, 0)


@pytest.mark.parametrize("recipe", ["experiments/VidSTG/e2e_STCAT_R101_VidSTG.yaml",
                                    "experiments/HC-STVG/e2e_STCAT_R101_HCSTVG.yaml"])
def test_config_recipes_merge_like_jax(recipe):
    import os

    from stcat_tpu.config import default_config as j_default, merge_from_file as j_merge, to_dict
    from stcat_tpu_torch import config as pc

    path = os.path.join(os.path.dirname(__file__), "..", recipe)
    opts = ["TPU.CONV_STAGES", "[1,2,3,4]", "MODEL.WEIGHT", ""]
    ours = pc.merge_from_list(pc.merge_from_file(pc.default_config(), path), opts)
    from stcat_tpu.config import merge_from_list as j_list

    theirs = j_list(j_merge(j_default(), path), opts)
    assert dataclasses.asdict(ours) == to_dict(theirs)
    assert dataclasses.asdict(pc.merge_from_list(pc.default_config(), [])) == \
        to_dict(tiny_cfg.__globals__["default_config"]())
