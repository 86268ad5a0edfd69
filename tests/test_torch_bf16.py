"""The port's bf16 compute against the JAX package's, on the CPU.

Every check runs the same numpy inputs (made from a seed) with the same
weights (JAX's init, handed to the port through ``stcat_tpu_torch.convert``)
three ways: the JAX package at float32 and at bfloat16 compute, and the port
at bfloat16. Per output or gradient tensor, with rel(a, b) = ||a - b|| / ||b||
(L2 over the tensor):

    e_jax  = rel(JAX bf16, JAX fp32)    how far the JAX package rounds
    e_port = rel(port bf16, JAX fp32)   how far the port rounds
    d      = rel(port bf16, JAX bf16)   how far apart the two roundings are

and both e_port and d must stay within M x e_jax + F (``hold``): the port
may round as far from fp32 as the JAX package does, not further, and where
the JAX package rounds. M and F were set from the readings at seeds 0-3 (see
their comment); the tests run seed 0. Two planted faults must each fail the
check: attention logits rounded to bf16 before the softmax (both packages
keep them fp32) and LayerNorm statistics in bf16 (both keep them fp32).
The modules follow the model from the input down: preprocess, RoBERTa,
ResNet (both CONV_IMPL routes with gradients, FrozenBN folded without; the
JAX fused block in Pallas's interpreter),
the cross-modal encoder, the decoders and heads, the whole STCATNet, the
postprocess, the train step's losses and gradients, and ``do_eval`` on the
learning proof's two clips. Widths are tiny: this is about rounding policy.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
import stcat_tpu_torch.convert as pconv
from stcat_tpu_torch.models import attention as pattn, roberta as proberta

T = torch.from_numpy
SEED = 0
BF16 = "bfloat16"

# The bound: per tensor, e_port and d <= M x e_jax + F. Readings at seeds
# 0-3 (scripts/torch_bf16_readings.py; PERF.md §6; the tests run seed
# 0): max(e_port, d) / e_jax is 0.92-1.09 for every module alone, up to
# 1.80 through the whole STCATNet (aux0's attention weights), 1.72 after the
# postprocess and 1.29 in do_eval. The planted faults read 2.7-3.6x
# (logits) and 3.2-6.3x (LayerNorm) on their stress cases.
M, F = 2.0, 2e-4
# The train step's loss terms: each is one number, whose bf16 error is one
# draw (seed 0: loss_giou_0 e_jax 3.5e-3, the port's 8.0e-3); F_LOSS is a
# few bf16 roundings of a sum.
F_LOSS = 1e-2
# Gradients. A ReLU or a max whose input lies within a bf16 rounding of its
# kink crosses in one route and not in another: at seed 0 one hidden unit of
# the last spatial-decoder layer's FFN moves that layer's gradients by 0.10
# where JAX's two roundings read 9e-3, at seed 2 one of the first
# time-decoder layer's by 0.04. Per tensor F_GRAD admits such a crossing,
# and the median over tensors of max(e_port, d) / e_jax (0.88-1.13 at seeds
# 0-3) must stay under MEDIAN: a rounding policy that differs moves every
# tensor, a crossing one layer.
F_GRAD, MEDIAN = 0.15, 1.5
# A gradient whose exact value is 0 (a key projection's bias: the softmax
# over keys ignores a constant; the sted head's output bias: each of its
# softmaxes over frames does; the first spatial-decoder layer's
# self-attention projections) is rounding noise in both packages, whose
# fp32 gradients then differ by more than NOISE_GAP (19 tensors at each of
# seeds 0-3; every other tensor's gap is under 2.3e-2). Such a tensor must
# be that small (its fp32 norm under NOISE_NORM: readings up to 2.6e-7) and
# is held by its size: its bf16 norm within NOISE_MULT x JAX's (readings up
# to 4.8x).
NOISE_GAP, NOISE_NORM, NOISE_MULT = 0.1, 1e-6, 20.0

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / n) if n > 0 else float(np.linalg.norm(a - b))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def readings(cases: dict) -> dict:
    """{name: (JAX fp32, JAX bf16, JAX bf16 strict or None, port bf16)} ->
    {name: (e_jax, e_port, d)}. XLA may keep a bf16 value in fp32 where the
    JAX source rounds it (excess precision, on by default); "strict" is the
    same computation compiled with that off, so every rounding the source
    writes is kept. e_jax is the farther of the two JAX bf16 results from
    fp32, d the port's distance to the nearer."""
    out = {}
    for name, (j32, j16, j16s, p16) in cases.items():
        j32, p16 = _np(j32), _np(p16)
        jax16 = [_np(j) for j in (j16, j16s) if j is not None]
        assert all(j32.shape == j.shape == p16.shape for j in jax16), (name, j32.shape,
                                                                       p16.shape)
        out[name] = (max(rel(j, j32) for j in jax16), rel(p16, j32),
                     min(rel(p16, j) for j in jax16))
    return out


def outside(reads: dict, floor: float = F) -> dict:
    """The tensors whose e_port or d exceeds M x e_jax + ``floor``."""
    return {name: dict(e_jax=e_jax, e_port=e_port, d=d, limit=M * e_jax + floor)
            for name, (e_jax, e_port, d) in reads.items()
            if not (e_port <= M * e_jax + floor and d <= M * e_jax + floor)}


def hold(cases: dict) -> dict:
    reads = readings(cases)
    bad = outside(reads)
    assert not bad, bad
    return reads


# --------------------------------------------------------------------------
# planted faults (each must fail the check)
# --------------------------------------------------------------------------

def _bf16_logits_core(q, k, v, key_valid=None, return_weights=False, dtype=torch.float32,
                      impl="xla", dropout_p=0.0, generator=None, tp=None):
    """attention_core's plain route with the logits rounded to the compute
    dtype before the softmax."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", (q.to(dtype) * scale).float(),
                          k.to(dtype).float()).to(dtype).float()
    if key_valid is not None:
        logits = torch.where(key_valid[:, None, None, :], logits, torch.full_like(logits, -1e9))
    weights = torch.softmax(logits - logits.amax(-1, keepdim=True), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", weights.to(dtype), v.to(dtype)).float()
    return out, (weights.mean(1) if return_weights else None)


def _bf16_stats_layer_norm(self, x):
    """LayerNorm with its mean and variance rounded to bf16."""
    x = x.float()
    mean = x.mean(-1, keepdim=True).to(torch.bfloat16).float()
    var = ((x - mean) ** 2).mean(-1, keepdim=True).to(torch.bfloat16).float()
    return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


@contextlib.contextmanager
def planted(kind: str):
    """The port with one fault planted: "bf16_logits" or "bf16_ln_stats"."""
    if kind == "bf16_logits":
        saved = pattn.attention_core, proberta.attention_core
        pattn.attention_core = proberta.attention_core = _bf16_logits_core
        try:
            yield
        finally:
            pattn.attention_core, proberta.attention_core = saved
    else:
        assert kind == "bf16_ln_stats", kind
        saved = proberta.LayerNorm.forward
        proberta.LayerNorm.forward = _bf16_stats_layer_norm
        try:
            yield
        finally:
            proberta.LayerNorm.forward = saved


# --------------------------------------------------------------------------
# the cases: {name: (JAX fp32, JAX bf16, JAX bf16 strict or None, port bf16)}
# for one seed
# --------------------------------------------------------------------------

def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def trained_like(variables, seed):
    """flax's init with every bias drawn from N(0, 0.5^2) and every
    LayerNorm scale from U(0.5, 1.5) (init leaves them 0 and 1), so the
    roundings of a bias add and of a norm's affine show, as they do in a
    trained model."""
    rng = np.random.RandomState(seed + 100)

    def draw(path, a):
        name = getattr(path[-1], "key", "")
        if name == "bias":
            return (rng.randn(*a.shape) * 0.5).astype(np.float32)
        if name == "scale" and path[0].key == "params":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, dict(variables))


STRICT = {"xla_allow_excess_precision": False}


def jax_runs(fn32, fn16, *args):
    """fn32(*args) and fn16(*args) jitted, and fn16 compiled strict (every
    bf16 rounding its source writes kept)."""
    return (jax.jit(fn32)(*args), jax.jit(fn16)(*args),
            jax.jit(fn16).lower(*args).compile(compiler_options=STRICT)(*args))


def _jax_apply(make, variables, *args, **kwargs):
    """JAX fp32, bf16 and strict bf16 outputs of ``make(dtype)`` with one set
    of variables."""
    fn = lambda dt: lambda v, *a: make(dt).apply(v, *a, **kwargs)  # noqa: E731
    return jax_runs(fn(jnp.float32), fn(jnp.bfloat16), variables, *args)


def case_preprocess(seed=SEED):
    """uint8 frames -> the normalized rgb frames in the compute dtype (the
    model's first cast)."""
    import dataclasses

    from stcat_tpu.core.batch import RawVideoBatch as JRaw
    from stcat_tpu.data.batching import build_raw_batch as j_build
    from stcat_tpu.data.tokenize import HashTokenizer as JTok
    from stcat_tpu.data.transforms import VideoTransform as JTransform
    from stcat_tpu.ops.preprocess import preprocess as j_pre
    from stcat_tpu_torch.core.batch import RawVideoBatch as PRaw
    from stcat_tpu_torch.ops.preprocess import preprocess as p_pre
    from test_torch_modules import _raw_samples

    jt = JTransform(64, is_train=False)
    empty = np.zeros((0, 4), np.float32)
    raw, _, _ = j_build(_raw_samples(lambda hw: jt.plan(hw, empty, "",
                                                         np.random.default_rng(seed))[0]),
                        8, JTok(128), 10)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    fields = {f.name: getattr(raw, f.name) for f in dataclasses.fields(JRaw)}
    fn = lambda dt: lambda r: j_pre(r, mean, std).frames.astype(dt)  # noqa: E731
    j32, j16, j16s = jax_runs(fn(jnp.float32), fn(jnp.bfloat16), JRaw(**fields))
    ours = p_pre(PRaw(**{k: (T(v) if isinstance(v, np.ndarray) else v)
                         for k, v in fields.items()}), mean, std)
    return {"frames": (j32, j16, j16s, ours.frames.to(torch.bfloat16))}


RKW = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
           max_position_embeddings=64)


def _tokens(rng, b=3, l=9):
    ids = rng.randint(3, 128, (b, l)).astype(np.int32)
    valid = np.ones((b, l), bool)
    valid[1, 6:] = False
    valid[2, 3:] = False
    return ids, valid


def case_roberta_layer(seed=SEED):
    from stcat_tpu.models.roberta import RobertaConfig as JCfg, RobertaLayer as JLayer
    from stcat_tpu_torch.models.roberta import RobertaConfig as PCfg, RobertaLayer as PLayer

    rng = np.random.RandomState(seed)
    _, valid = _tokens(rng)
    x = rng.randn(*valid.shape, RKW["hidden_size"]).astype(np.float32)
    var = trained_like(jax.jit(JLayer(JCfg(**RKW)).init)(jax.random.PRNGKey(seed), x, valid),
                       seed)
    j32, j16, j16s = _jax_apply(lambda dt: JLayer(JCfg(**RKW), dtype=dt), var, x, valid)
    p, w = var["params"], pconv.Writer()
    for ours, theirs in (("q_proj", "query"), ("k_proj", "key"), ("v_proj", "value")):
        w.dense(f"attention.self.{theirs}", p["attention"][ours])
    w.dense("attention.output.dense", p["attention"]["out_proj"])
    w.norm("attention.output.LayerNorm", p["attn_ln"])
    w.dense("intermediate.dense", p["intermediate"])
    w.dense("output.dense", p["output"])
    w.norm("output.LayerNorm", p["out_ln"])
    ours = PLayer(PCfg(**RKW), torch.bfloat16).eval()
    ours.load_state_dict(w.sd, strict=True)
    with torch.no_grad():
        return {"layer": (j32, j16, j16s, ours(T(x), T(valid)))}


def case_roberta_encoder(seed=SEED):
    from stcat_tpu.models.roberta import RobertaConfig as JCfg, TextEncoder as JText
    from stcat_tpu_torch.models.roberta import RobertaConfig as PCfg, TextEncoder as PText

    ids, valid = _tokens(np.random.RandomState(seed))
    var = trained_like(jax.jit(JText(d_model=48, cfg=JCfg(**RKW)).init)(
        jax.random.PRNGKey(seed), ids, valid), seed)
    js = _jax_apply(lambda dt: JText(48, JCfg(**RKW), dtype=dt), var, ids, valid)
    p = var["params"]
    sd = _state_dict_of(lambda w: (pconv.roberta(w, p["roberta"], "body."),
                                   w.dense("resizer.fc", p["resizer"]["fc"]),
                                   w.norm("resizer.layer_norm", p["resizer"]["ln"])))
    ours = PText(48, PCfg(**RKW), torch.bfloat16).eval()
    ours.load_state_dict(sd, strict=True)
    with torch.no_grad():
        feats, cls = ours(T(ids), T(valid))
    return {"text_feats": (*(j[0] for j in js), feats), "text_cls": (*(j[1] for j in js), cls)}


PEAKED = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
              max_position_embeddings=64)


def case_text_encoder_stress(seed=SEED, offset=8.0):
    """The text encoder where the two planted faults matter: heads of
    roberta-base's width (64), each layer's key projection tied to its
    query projection (coherent logits, as trained attention has them) and a
    common offset in the token-type embedding, so every token's embedding
    carries a mean far from its spread."""
    from stcat_tpu.models.roberta import RobertaConfig as JCfg, TextEncoder as JText
    from stcat_tpu_torch.models.roberta import RobertaConfig as PCfg, TextEncoder as PText

    ids, valid = _tokens(np.random.RandomState(seed))
    var = trained_like(jax.jit(JText(d_model=48, cfg=JCfg(**PEAKED)).init)(
        jax.random.PRNGKey(seed), ids, valid), seed)
    p = var["params"]["roberta"]
    rng = np.random.RandomState(seed + 200)
    row = p["token_type_embeddings"]["embedding"]
    p["token_type_embeddings"]["embedding"] = (offset + 0.1 * rng.randn(*row.shape)).astype(
        np.float32)
    for i in range(PEAKED["num_layers"]):
        attn = p[f"layer_{i}"]["attention"]
        attn["k_proj"] = dict(attn["q_proj"])
    js = _jax_apply(lambda dt: JText(48, JCfg(**PEAKED), dtype=dt), var, ids, valid)
    sd = _state_dict_of(lambda w: (pconv.roberta(w, p, "body."),
                                   w.dense("resizer.fc", var["params"]["resizer"]["fc"]),
                                   w.norm("resizer.layer_norm", var["params"]["resizer"]["ln"])))
    ours = PText(48, PCfg(**PEAKED), torch.bfloat16).eval()
    ours.load_state_dict(sd, strict=True)
    with torch.no_grad():
        feats, cls = ours(T(ids), T(valid))
    return {"text_feats": (*(j[0] for j in js), feats), "text_cls": (*(j[1] for j in js), cls)}


def _state_dict_of(write) -> dict:
    w = pconv.Writer()
    write(w)
    return w.sd


def case_resnet(route: str, seed=SEED):
    """The stem (conv + FrozenBN), layer1's first block (stride 1: the fused
    block on the "pallas" route) and layer2's (stride 2), by their outputs
    inside the backbone. "xla" and "pallas" run the port with gradients on
    (the stem, which never takes one, on its own), "folded" without: every
    FrozenBN folded into its conv, layer1's block through the fused kernel,
    held to the JAX package's "pallas" route; its stem is compared after
    the ReLU, which the card's folded stem runs in cuDNN's epilogue (the
    ReLU of JAX's stem_bn is exact in either precision)."""
    conv_impl = "pallas" if route == "folded" else route
    from stcat_tpu.kernels import conv as jconv
    from stcat_tpu.models.resnet import build_resnet as j_build
    from stcat_tpu_torch.models.resnet import build_resnet as p_build

    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 64, 64, 3) * 0.5).astype(np.float32)
    jmodel, _ = j_build("resnet50", False, depths=(1, 1, 1, 1), frozen_stages=0)
    var = _tree(jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.asarray(x)))
    consts = jax.tree_util.tree_map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                                    var["constants"])
    variables = {"params": var["params"], "constants": consts}
    names = ("stem_bn", "layer1_0", "layer2_0")

    def fn(dt):
        m, _ = j_build("resnet50", False, dtype=dt, depths=(1, 1, 1, 1), frozen_stages=0,
                       conv_impl=conv_impl)

        def run(v, a):
            _, inter = m.apply(v, a, capture_intermediates=lambda mdl, _: mdl.name in names,
                               mutable=["intermediates"])
            return {n: inter["intermediates"][n]["__call__"][0] for n in names}
        return run

    saved = jconv._INTERPRET
    jconv._INTERPRET = True  # the fused block through Pallas's interpreter, as its tests run it
    try:
        outs = jax_runs(fn(jnp.float32), fn(jnp.bfloat16), variables, jnp.asarray(x))
    finally:
        jconv._INTERPRET = saved
    ours = p_build("resnet50", False, dtype=torch.bfloat16, depths=(1, 1, 1, 1),
                   conv_impl=conv_impl, frozen_stages=0).eval()
    ours.load_state_dict(_state_dict_of(lambda w: pconv.backbone(w, var["params"], consts)),
                         strict=True)
    got = {}
    hooks = [mod.register_forward_hook(lambda m, a, o, n=n: got.__setitem__(n, o))
             for n, mod in (("stem_bn", ours.bn1), ("layer1_0", ours.layer1[0]),
                            ("layer2_0", ours.layer2[0]))]
    with torch.no_grad() if route == "folded" else torch.enable_grad():
        ours(T(x))
        stem = ours.stem(T(x))
    for h in hooks:
        h.remove()
    if route == "folded":
        got["stem_bn"] = stem
        outs = [dict(o, stem_bn=jnp.maximum(o["stem_bn"], 0)) for o in outs]
    return {n: (*(o[n] for o in outs), _nhwc(got[n], outs[0][n].shape)) for n in names}


def _nhwc(t: torch.Tensor, shape) -> torch.Tensor:
    """A port activation in NHWC, whatever layout its module returned."""
    if tuple(t.shape) == tuple(shape):
        return t
    return t.permute(0, 2, 3, 1)


D, HEADS, FFN, LAYERS = 64, 4, 128, 2


def _encoder_inputs(seed, b=2, t=5, hf=3, wf=4, l=6):
    """Visual features with padded pixels and frames, text with padded tokens."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    vis_valid = np.ones((b, t, hf, wf), bool)
    vis_valid[1, :, 2:, :] = False
    text_valid = np.ones((b, l), bool)
    text_valid[0, 4:] = False
    frame_valid = np.ones((b, t), bool)
    frame_valid[1, 3:] = False
    return (f(b, t, hf, wf, D), vis_valid, f(b, t, hf, wf, D), f(b, l, D), text_valid,
            frame_valid)


def case_encoder_layer(impl: str, seed=SEED):
    """One encoder layer on a spatial-like sequence (grid + text tokens, some
    padded) and on a temporal-like one (frames, some padded)."""
    from stcat_tpu.models.encoder import TransformerEncoderLayer as JLayer
    from stcat_tpu_torch.models.encoder import TransformerEncoderLayer as PLayer

    rng = np.random.RandomState(seed)
    out = {}
    for name, (b, s, pad) in (("spatial", (4, 19, 5)), ("temporal", (6, 9, 3))):
        x, pos = (rng.randn(b, s, D).astype(np.float32) for _ in range(2))
        valid = np.ones((b, s), bool)
        valid[1:, s - pad:] = False
        var = trained_like(jax.jit(JLayer(D, HEADS, FFN, 0.0).init)(
            jax.random.PRNGKey(seed), x, pos, valid), seed)
        js = _jax_apply(lambda dt: JLayer(D, HEADS, FFN, 0.0, dtype=dt, impl=impl), var, x, pos,
                        valid)
        ours = PLayer(D, HEADS, FFN, dtype=torch.bfloat16, impl=impl).eval()
        ours.load_state_dict({k[len("l."):]: v for k, v in _state_dict_of(
            lambda w: w.encoder_layer("l", var["params"])).items()}, strict=True)
        with torch.no_grad():
            out[name] = (*js, ours(T(x), T(pos), T(valid)))
    return out


def case_encoder(impl: str, seed=SEED):
    """The cross-modal encoder stack (2 spatial + 2 temporal layers)."""
    from stcat_tpu.models.encoder import CrossModalEncoder as JEnc
    from stcat_tpu_torch.models.encoder import CrossModalEncoder as PEnc

    args = _encoder_inputs(seed)
    var = trained_like(jax.jit(JEnc(D, HEADS, FFN, LAYERS, max_video_len=32, dropout=0.0).init)(
        jax.random.PRNGKey(seed), *args), seed)
    js = _jax_apply(lambda dt: JEnc(D, HEADS, FFN, LAYERS, max_video_len=32, dropout=0.0,
                                    dtype=dt, impl=impl), var, *args)
    ours = PEnc(D, HEADS, FFN, LAYERS, 32, False, dtype=torch.bfloat16, impl=impl).eval()
    ours.load_state_dict(_state_dict_of(lambda w: pconv.encoder(w, var["params"])), strict=True)
    with torch.no_grad():
        outs = ours(*map(T, args))
    names = ("memory", "mem_valid", "frames_cls", "videos_cls")
    return {n: (*(j[i] for j in js), o) for i, (n, o) in enumerate(zip(names, outs))
            if o.dtype != torch.bool}


def _decoder_inputs(seed, b=2, t=5, m=7):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    mem_valid = np.ones((b, t, m), bool)
    mem_valid[0, :, 5:] = False
    mem_valid[1, 2, :] = False          # a frame with no attendable memory
    frame_valid = np.ones((b, t), bool)
    frame_valid[1, 4:] = False
    return rng, f, mem_valid, frame_valid


def case_spatial_decoder_layer(impl: str, seed=SEED):
    from stcat_tpu.models.decoder import SpatialDecoderLayer as JLayer
    from stcat_tpu_torch.models.decoder import SpatialDecoderLayer as PLayer

    rng, f, mem_valid, frame_valid = _decoder_inputs(seed)
    b, t, m = mem_valid.shape
    args = (f(b, t, D), f(b, t, m, D), mem_valid, f(b, t, m, D), f(b, t, D), f(b, t, D),
            f(b, t, D), frame_valid)
    var = trained_like(jax.jit(lambda k, *a: JLayer(D, HEADS, FFN, 0.0).init(
        k, *a, is_first=True))(jax.random.PRNGKey(seed), *args), seed)
    js = [out[0] for out in _jax_apply(
        lambda dt: JLayer(D, HEADS, FFN, 0.0, dtype=dt, impl=impl), var, *args, is_first=True)]
    ours = PLayer(D, HEADS, FFN, dtype=torch.bfloat16, impl=impl).eval()
    ours.load_state_dict({k[len("layers.0."):]: v for k, v in _state_dict_of(
        lambda w: pconv.spatial_decoder(w, {"query_scale": {}, "ref_point_head": {},
                                            "norm": var["params"]["norm1"],
                                            "layer_0": var["params"]})).items()
        if k.startswith("layers.0.")}, strict=True)
    with torch.no_grad():
        return {"tgt": (*js, ours(*map(T, args)))}


def case_time_decoder_layer(impl: str, seed=SEED, heads=HEADS, tied=False, scale=1.0):
    """A time decoder layer: its state and its self-attention weights (the
    guided-attention loss's input). ``tied``: the self-attention's key
    projection tied to its query projection, and ``scale`` on the inputs."""
    from stcat_tpu.models.decoder import TimeDecoderLayer as JLayer
    from stcat_tpu_torch.models.decoder import TimeDecoderLayer as PLayer

    _, f, mem_valid, frame_valid = _decoder_inputs(seed + 1)
    b, t, m = mem_valid.shape
    args = (f(b, t, D) * scale, f(b, t, m, D), mem_valid, f(b, t, m, D), f(b, t, D) * scale,
            f(b, t, D) * scale, frame_valid)
    var = trained_like(jax.jit(JLayer(D, heads, FFN, 0.0).init)(jax.random.PRNGKey(seed), *args),
                       seed)
    if tied:
        attn = var["params"]["self_attn"]
        attn["k_proj"] = dict(attn["q_proj"])
    js = _jax_apply(lambda dt: JLayer(D, heads, FFN, 0.0, dtype=dt, impl=impl), var, *args)
    ours = PLayer(D, heads, FFN, dtype=torch.bfloat16, impl=impl).eval()
    ours.load_state_dict({k[len("layers.0."):]: v for k, v in _state_dict_of(
        lambda w: pconv.time_decoder(w, {"norm": var["params"]["norm1"],
                                         "layer_0": var["params"]})).items()
        if k.startswith("layers.0.")}, strict=True)
    with torch.no_grad():
        tgt, weights = ours(*map(T, args))
    return {"tgt": (*(j[0] for j in js), tgt), "weights": (*(j[1] for j in js), weights)}


def case_heads(seed=SEED):
    """The MLP heads (box, sted, actioness), which both packages run in fp32
    at either compute dtype: JAX bf16 is JAX fp32 here."""
    from stcat_tpu.models.decoder import MLP as JMLP
    from stcat_tpu_torch.models.decoder import MLP as PMLP

    x = np.random.RandomState(seed).randn(2, 5, D).astype(np.float32)
    out = {}
    for name, (dout, layers) in (("bbox_embed", (4, 3)), ("temp_embed", (2, 2)),
                                 ("action_embed", (1, 2))):
        var = trained_like(JMLP(D, dout, layers).init(jax.random.PRNGKey(seed), x), seed)
        j32 = JMLP(D, dout, layers).apply(var, x)
        ours = PMLP(D, D, dout, layers)
        ours.load_state_dict({k[len("mlp."):]: v for k, v in _state_dict_of(
            lambda w: w.mlp("mlp", var["params"])).items()}, strict=True)
        with torch.no_grad():
            out[name] = (j32, j32, None, ours(T(x)))
    return out


def port_cfg(jcfg):
    from stcat_tpu.config import to_dict
    from stcat_tpu_torch import config as pconfig

    return pconfig._merge_dict(pconfig.default_config(), to_dict(jcfg))


def _dtype_cfgs(extra=()):
    from stcat_tpu.config import merge_from_list

    jcfg = tiny_cfg(list(extra))
    return jcfg, merge_from_list(jcfg, ["TPU.COMPUTE_DTYPE", BF16])


def case_stcatnet(seed=SEED):
    """The whole STCATNet forward, aux_outputs included, on a batch with
    padded frames, pixels and tokens (test_torch_model.py's), JAX weights,
    every kernel route on (the JAX fused block on XLA: its kernel runs only
    on a TPU or in the interpreter)."""
    from stcat_tpu.core.batch import VideoBatch as JBatch
    from stcat_tpu.models import STCATNet as JNet
    from stcat_tpu_torch.convert import from_jax_variables
    from stcat_tpu_torch.core.batch import VideoBatch as PBatch
    from stcat_tpu_torch.models import STCATNet as PNet
    from test_torch_model import _batch_arrays

    jcfg, jcfg16 = _dtype_cfgs(["TPU.CONV_IMPL", "pallas", "TPU.CONV_STAGES", "[1,2,3,4]"])
    arrays = _batch_arrays(seed=seed)
    jbatch = JBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    variables = trained_like(jax.jit(JNet(jcfg).init)(jax.random.PRNGKey(seed), jbatch), seed)
    j32, j16, j16s = jax_runs(JNet(jcfg).apply, JNet(jcfg16).apply, variables, jbatch)
    ours = PNet(port_cfg(jcfg16)).eval()
    ours.load_state_dict(from_jax_variables(variables["params"], variables["constants"]),
                         strict=True)
    with torch.no_grad():
        p16 = ours(PBatch(**{k: T(v) for k, v in arrays.items()}))
    out = {k: (j32[k], j16[k], j16s[k], p16[k])
           for k in ("pred_boxes", "pred_sted", "pred_actioness", "weights")}
    for i, outs in enumerate(zip(j32["aux_outputs"], j16["aux_outputs"], j16s["aux_outputs"],
                                 p16["aux_outputs"])):
        out.update({f"aux{i}.{k}": tuple(o[k] for o in outs) for k in outs[0]})
    return out, arrays


def spans_checked(j16_rows, p16_rows):
    """Per row (sted [T, 2] and frame mask): where JAX bf16's span wins by a
    margin over twice the largest |delta pred_sted| between the two bf16
    outputs, the port's span must be JAX's. Returns the rows compared and
    those that differ."""
    from torch_learning import span_margin

    checked, differ = 0, []
    for i, (j, p) in enumerate(zip(j16_rows, p16_rows)):
        fv = j["frame_valid"]
        span, margin = span_margin(j["pred_sted"], fv)
        gap = (p["pred_sted"] - j["pred_sted"])[fv].abs().max().item()
        if margin > 2 * gap:
            checked += 1
            if span_margin(p["pred_sted"], fv)[0] != span:
                differ.append(i)
    return checked, differ


def case_postprocess(outputs, arrays):
    """Boxes in original pixels from each package's postprocess of its own
    bf16 outputs, the boxes and spans of both postprocesses on one set of
    outputs (JAX's bf16), and ``spans_checked`` on each package's bf16
    sted."""
    from stcat_tpu.models.postprocess import postprocess as j_post
    from stcat_tpu_torch.models.postprocess import postprocess as p_post

    sizes, mask = np.asarray([[240, 320], [480, 640]], np.int32), arrays["frame_valid"]
    boxes, sted = ([_np(o) if o is not None else None for o in outputs[k]]
                   for k in ("pred_boxes", "pred_sted"))
    jpost = lambda b, s: [np.asarray(a) for a in j_post(  # noqa: E731
        jnp.asarray(b), jnp.asarray(s), jnp.asarray(sizes), jnp.asarray(mask))]
    ppost = lambda b, s: [a.numpy() for a in p_post(T(b), T(s), T(sizes), T(mask))]  # noqa: E731
    same = (jpost(boxes[1], sted[1]), ppost(boxes[1], sted[1]))
    rows = lambda st: [{"pred_sted": T(r), "frame_valid": T(m)}  # noqa: E731
                       for r, m in zip(st, mask)]
    return ({"boxes": (jpost(boxes[0], sted[0])[0], jpost(boxes[1], sted[1])[0],
                       jpost(boxes[2], sted[2])[0], ppost(boxes[3], sted[3])[0])},
            same, spans_checked(rows(sted[1]), rows(sted[3])))


def case_train_step(seed=SEED):
    """The train step's loss terms and every trained parameter's gradient
    (tests/test_torch_train.py's slice at CONV_IMPL xla: the JAX package's
    bf16 fused-block backward raises). Also returns the port's fp32
    gradients' distance to JAX's, per tensor: where the two packages'
    fp32 gradients already disagree, that is the floor."""
    from stcat_tpu.models import STCATNet as JNet
    from stcat_tpu.train import criterion as jcrit
    from stcat_tpu_torch.convert import from_jax_variables
    from stcat_tpu_torch.models import build_model
    from stcat_tpu_torch.train import criterion as pcrit
    from stcat_tpu_torch.train.optimizer import label_params
    from test_torch_train import NO_DROPOUT, SLICE, _jax_inputs, clip_arrays, port_batch

    jcfg, jcfg16 = _dtype_cfgs(NO_DROPOUT + SLICE + ["TPU.CONV_IMPL", "xla"])
    arrays = clip_arrays(seed=seed)
    jb, jt = _jax_inputs(arrays)
    variables = trained_like(jax.jit(JNet(jcfg).init)(jax.random.PRNGKey(seed), jb), seed)
    params, consts = variables["params"], variables["constants"]
    s = jcfg.SOLVER
    num_boxes = jnp.maximum(jt.box_valid.sum() / jt.box_valid.shape[0], 1.0)

    def jloss(c):
        weights, model = jcrit.build_weight_dict(c), JNet(c)

        def loss(p):
            out = model.apply({"params": p, "constants": consts}, jb, deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(0)})
            terms = jcrit.video_stg_loss(out, jt, jb.frame_valid, num_boxes, sigma=s.SIGMA,
                                         eos_coef=s.EOS_COEF)
            return sum(terms[k] * w for k, w in weights.items()), terms
        return jax.value_and_grad(loss, has_aux=True)

    jruns = [(terms, from_jax_variables(_tree(grads), consts))
             for (_, terms), grads in jax_runs(jloss(jcfg), jloss(jcfg16), params)]

    def pgrads(c):
        cfg = port_cfg(c)
        model = build_model(cfg, device="cpu", seed=seed)
        model.load_state_dict(from_jax_variables(params, consts))
        model.train()
        batch, targets = port_batch(arrays)
        terms = pcrit.video_stg_loss(model(batch), targets, batch.frame_valid,
                                     torch.tensor(float(num_boxes)), sigma=s.SIGMA,
                                     eos_coef=s.EOS_COEF)
        sum(terms[k] * w for k, w in pcrit.build_weight_dict(cfg).items()).backward()
        labels = label_params(cfg, model)
        return terms, {n: p.grad for n, p in model.named_parameters()
                       if labels[n] != "frozen" and not n.startswith("text_encoder.body.pooler.")}

    (pt32, pg32), (pt16, pg16) = pgrads(jcfg), pgrads(jcfg16)
    cases = {f"loss.{k}": (*(t[k] for t, _ in jruns), pt16[k]) for k in pt16}
    cases.update({f"grad.{n}": (*(g[n] for _, g in jruns), g16) for n, g16 in pg16.items()})
    fp32_gap = {f"grad.{n}": rel(_np(g), _np(jruns[0][1][n])) for n, g in pg32.items()}
    return cases, fp32_gap


def case_do_eval(tmp, seed=SEED):
    """eval/engine.py::do_eval on the learning proof's two 12-frame clips
    (padded to a bucket of 16, split into two streams; K1's route for the
    encoder and the decoders' cross-attention), from the JAX package's
    initial weights for the proof: each row's pred_boxes and pred_sted, and
    the spans where the margin allows (``spans_checked``)."""
    import types

    import torch_learning as tl
    from stcat_tpu_torch.models import build_model
    from test_torch_learning import _jax_initial_weights, jax_evaluate

    extra = ["TPU.CONV_IMPL", "pallas", "TPU.CONV_STAGES", "[1,2,3,4]"]
    sd = _jax_initial_weights(tmp / "init")
    (res32, j32), (res16, j16) = (jax_evaluate(tmp / dt, sd, dt, extra)
                                  for dt in ("float32", "bfloat16"))
    cfg = tl.learning_cfg(str(tmp / "port"), extra)
    model = build_model(cfg, "cpu", seed=cfg.SEED)
    model.load_state_dict(sd)
    state = types.SimpleNamespace(model=model, ema=None, step=0)
    res, p16 = tl.evaluate(cfg, state, "cpu", BF16)
    triples = {}
    for i, (a, b, c) in enumerate(zip(j32, j16, p16)):
        fv = a["frame_valid"]
        assert torch.equal(fv, b["frame_valid"]) and torch.equal(fv, c["frame_valid"])
        for k in ("pred_boxes", "pred_sted"):
            triples[f"row{i}.{k}"] = (a[k][fv], b[k][fv], None, c[k][fv])
    return triples, spans_checked(j16, p16), (res32, res16, res)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

def test_preprocess_bf16_matches_jax():
    """The normalized frames in bf16: the same rounding, to within the rare
    fp32 difference of the normalize that lands on a bf16 tie."""
    reads = hold(case_preprocess())
    assert reads["frames"][2] < 1e-4


@pytest.mark.parametrize("case", ["layer", "encoder"])
def test_roberta_bf16_matches_jax(case):
    """One RoBERTa layer, then the text encoder (2 layers, the resizer) with
    padded tokens. GELU in bf16 is a settled difference: torch rounds the
    fp32 GELU once, XLA rounds its own erf chain (d ~ 0.5 x e_jax)."""
    hold(case_roberta_layer() if case == "layer" else case_roberta_encoder())


@pytest.mark.parametrize("route", ["xla", "pallas", "folded"])
def test_resnet_bf16_matches_jax(route):
    """The stem, layer1's stride-1 block (the fused block on "pallas" and
    "folded": the port's plain version against JAX's kernel in Pallas's
    interpreter) and layer2's stride-2 block."""
    hold(case_resnet(route))


@pytest.mark.parametrize("case", ["layer", "stack_xla", "stack_pallas"])
def test_encoder_bf16_matches_jax(case):
    """One encoder layer (spatial-like and temporal-like sequences, padded),
    then the cross-modal stack with padded pixels, frames and tokens on both
    attention routes."""
    hold(case_encoder_layer("pallas") if case == "layer"
         else case_encoder(case.split("_")[1]))


@pytest.mark.parametrize("case", ["spatial_layer", "time_layer", "heads"])
def test_decoders_bf16_match_jax(case):
    """A spatial decoder layer (first layer: ca_qpos_proj), a time decoder
    layer (state and self-attention weights) and the MLP heads."""
    hold({"spatial_layer": lambda: case_spatial_decoder_layer("pallas"),
          "time_layer": lambda: case_time_decoder_layer("pallas"),
          "heads": case_heads}[case]())


def test_stcatnet_and_postprocess_bf16_match_jax():
    """The whole forward, aux outputs included; then the postprocess: both
    packages' postprocess on JAX's bf16 outputs give the same spans and
    boxes, each package's own boxes are held by the bound, and wherever JAX's
    bf16 span wins by more than twice the sted gap the port's span is the
    same."""
    outputs, arrays = case_stcatnet()
    hold(outputs)
    boxes, (jpost, ppost), (checked, differ) = case_postprocess(outputs, arrays)
    hold(boxes)
    np.testing.assert_allclose(ppost[0], jpost[0], rtol=1e-6, atol=1e-4)
    for a, b in zip(ppost[1:], jpost[1:]):
        np.testing.assert_array_equal(a, b)
    assert not differ, (checked, differ)


def test_train_step_bf16_losses_and_gradients_match_jax():
    """Loss terms by the bound with F_LOSS; every gradient by the bound with
    F_GRAD, the median ratio under MEDIAN, and the zero-gradient tensors
    (noise in both packages) by their size."""
    cases, fp32_gap = case_train_step()
    reads = readings(cases)
    noise = {n for n, g in fp32_gap.items() if g > NOISE_GAP}
    for n in noise:  # nothing of real size hides there
        assert np.linalg.norm(_np(cases[n][0])) < NOISE_NORM, n
        j16 = max(np.linalg.norm(_np(j)) for j in cases[n][1:3])
        assert np.linalg.norm(_np(cases[n][3])) <= NOISE_MULT * j16, n
    losses = {n: r for n, r in reads.items() if n.startswith("loss.")}
    grads = {n: r for n, r in reads.items() if n.startswith("grad.") and n not in noise}
    assert not outside(losses, F_LOSS), outside(losses, F_LOSS)
    assert not outside(grads, F_GRAD), outside(grads, F_GRAD)
    ratio = np.median([max(e_port, d) / e_jax for e_jax, e_port, d in grads.values() if e_jax])
    assert ratio < MEDIAN, ratio


def test_do_eval_bf16_matches_jax(tmp_path):
    """do_eval on the learning proof's two clips from the JAX package's
    initial weights: each forward row's boxes and sted logits by the bound,
    and the spans wherever the margin decides them."""
    cases, (checked, differ), _ = case_do_eval(tmp_path)
    hold(cases)
    assert not differ, (checked, differ)


STRESS = {"text_encoder": lambda: case_text_encoder_stress(),
          "peaked_self_attention": lambda: case_time_decoder_layer("pallas", heads=1, tied=True,
                                                                   scale=0.2)}


@pytest.mark.parametrize("fault", ["bf16_logits", "bf16_ln_stats"])
def test_planted_faults_fail_the_check(fault):
    """The stress cases pass the check as the port stands and fail it with
    the fault planted: attention logits rounded to bf16 before the softmax
    (caught on the peaked self-attention's weights) or LayerNorm statistics
    in bf16 (caught where the embeddings carry a common offset)."""
    for case in STRESS.values():
        assert not outside(readings(case()))
    with planted(fault):
        caught = {name: outside(readings(case())) for name, case in STRESS.items()}
    assert any(caught.values()), caught
