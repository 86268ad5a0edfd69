"""The published model at its full widths and depth, with seeded weights and
inputs (torch only).

    cfg = full_cfg()                       # fp32; full_cfg("bfloat16") for bf16
    sd = weight_set()                      # reference-named fp32 state_dict
    torch.save(sd, path)                   # a .pth either package's loader takes
    reqs = requests(SERVED)                # the served batch (two requests)
    raw, targets = train_batch(cfg)        # one clip with its targets

The configuration is the VidSTG R101 recipe (ResNet-101 3-4-23-3,
RoBERTa-base with vocab 50265 and MAX_POS 514, d 256 with 8 heads, 6/6/6
layers, FFN 2048, QUERY_DIM 4) with chip_smoke.py's kernel routes, every
dropout 0 and the hash tokenizer. What is cut, and only that: frames per
clip (FRAME_BUCKETS [4, 32] where the recipe serves [32, 64, 96, 128]), the
frame size (240x320 clips) and, for the train step, INPUT.RESOLUTION (CUTS).

The weights are drawn from ``np.random.RandomState(SEED)``, key by key in
sorted order, in float64 and cast to fp32, so the same bytes come out on
every machine (``checksum``). Each matrix and convolution is drawn at its
fan-in's scale (2 / fan_in ahead of a ReLU), so activations stay of order 1
through all 33 blocks; biases are nonzero and norm scales 1 + N(0, 0.1^2)
(zero biases would hide where a bias is added); FrozenBN buffers are drawn
in the folded form (mean 0, var 1 - eps) that the JAX package's converter
returns.

tests/test_torch_full_scale.py holds the port to a fresh JAX run on the CPU
with these; scripts/torch_full_scale_fixture.py writes the JAX outputs to
tests/assets/torch_full_scale/, which chip_smoke.py phase 11 holds the card
to.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from stcat_tpu_torch.config import default_config, merge_from_file, merge_from_list
from stcat_tpu_torch.core.batch import to_device
from stcat_tpu_torch.data.batching import build_raw_batch
from stcat_tpu_torch.data.tokenize import build_tokenizer
from stcat_tpu_torch.data.transforms import build_transforms
from stcat_tpu_torch.models import STCATNet
from stcat_tpu_torch.models.attention import MultiHeadAttention
from stcat_tpu_torch.models.resnet import BN_EPS, FrozenBatchNorm2d
from stcat_tpu_torch.ops.preprocess import preprocess
from stcat_tpu_torch.serve import GroundingPredictor
from stcat_tpu_torch.train.optimizer import label_params, make_optimizer
from stcat_tpu_torch.train.step import accumulate_grads
from torch_learning import span_margin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "experiments/VidSTG/e2e_STCAT_R101_VidSTG.yaml")
FIXTURE = os.path.join(ROOT, "tests/assets/torch_full_scale")
SEED = 0

# chip_smoke.py's recipe_cfg, every dropout 0 (so training attention takes
# the kernel route), the hash tokenizer, frame buckets cut to [4, 32]
OPTS = (
    "MODEL.WEIGHT", "", "TPU.CONV_IMPL", "pallas", "TPU.CONV_STAGES", "[1,2,3,4]",
    "TPU.FRAME_BUCKETS", "[4,32]", "MODEL.STCAT.DROPOUT", "0.0",
    "MODEL.STCAT.HEAD_DROPOUT", "0.0", "MODEL.TEXT_MODEL.DROPOUT", "0.0",
    "MODEL.TEXT_MODEL.ALLOW_HASH_TOKENIZER", "true",
)
# the served batch: two requests of 240x320 frames into 2 x 2 lanes of a
# 32-frame bucket; the second request's streams (20 frames) are padded
SERVED = ((64, "the man in a red shirt walks to the left"),
          (40, "a dog jumps over the fence"))
# the tier-1 request: one 7-frame clip, streams of 4 and 3 frames in a
# 4-frame bucket (2 lanes), at the recipe's 448 px
SMALL = ((7, "a child holds a ball"),)
FRAME_HW = (240, 320)
# the train step: one clip at a cut resolution
TRAIN_FRAMES, TRAIN_RESOLUTION = 16, 224
TRAIN_TEXT = "the woman rides a bicycle"
TRAIN_OPTS = ("INPUT.RESOLUTION", str(TRAIN_RESOLUTION), "TPU.GRAD_ACCUM", "1",
              "SOLVER.WARMUP_PROP", "0.0")
CUTS = {
    "TPU.FRAME_BUCKETS": "[4, 32] (recipe [32, 64, 96, 128]; chip_smoke.py [64])",
    "frame size": f"{FRAME_HW[0]}x{FRAME_HW[1]} clips",
    "served": f"{len(SERVED)} requests of {[t for t, _ in SERVED]} frames, max_batch 2",
    "tier-1 request": f"{SMALL[0][0]} frames, max_batch 1",
    "train step": f"1 clip of {TRAIN_FRAMES} frames at INPUT.RESOLUTION {TRAIN_RESOLUTION} "
                  f"(recipe 448), GRAD_ACCUM 1",
}


def full_cfg(dtype: str = "float32", *opts):
    """The published model's config (see the module docstring)."""
    cfg = merge_from_file(default_config(), RECIPE)
    return merge_from_list(cfg, list(OPTS) + ["TPU.COMPUTE_DTYPE", dtype, *opts])


def train_cfg(dtype: str = "float32"):
    """The train step's config: full_cfg with TRAIN_OPTS."""
    return full_cfg(dtype, *TRAIN_OPTS)


def meta_model(cfg=None) -> STCATNet:
    """The port's STCATNet on the meta device: names and shapes, no storage."""
    with torch.device("meta"):
        return STCATNet(cfg if cfg is not None else full_cfg())


def _kinds(model: nn.Module) -> Dict[str, str]:
    """Each state_dict key's draw: conv_relu, conv, matrix, box_delta,
    embedding, scale, bias, bn_scale, bn_branch_scale, bn_mean, bn_var."""
    kinds = {}
    for mname, mod in model.named_modules():
        pre = mname + "." if mname else ""
        for pname, _ in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            key = pre + pname
            if isinstance(mod, FrozenBatchNorm2d):
                # the residual branch's last norm and the projection's keep a
                # 23-block stage of order 1
                branch = mname.endswith((".bn3", ".downsample.1"))
                kinds[key] = {"weight": "bn_branch_scale" if branch else "bn_scale",
                              "bias": "bias", "running_mean": "bn_mean",
                              "running_var": "bn_var"}[pname]
            elif pname.endswith("bias"):
                kinds[key] = "bias"
            elif key == "bbox_embed.layers.2.weight":
                kinds[key] = "box_delta"
            elif isinstance(mod, nn.Conv2d):
                kinds[key] = "conv_relu" if mname.startswith("vis_encoder.") else "conv"
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                kinds[key] = "scale"
            elif isinstance(mod, (nn.Linear, MultiHeadAttention)):
                kinds[key] = "matrix"
            else:  # embedding tables, learned tokens and time tables
                kinds[key] = "embedding"
    return kinds


def _draw(kind: str, shape: Tuple[int, ...], rng: np.random.RandomState) -> np.ndarray:
    if kind == "bn_mean":
        return np.zeros(shape, np.float32)
    if kind == "bn_var":
        return np.full(shape, 1.0 - BN_EPS, np.float32)
    x = rng.standard_normal(shape)  # float64
    fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    if kind == "conv_relu":
        x *= np.sqrt(2.0 / fan_in)
    elif kind in ("conv", "matrix"):
        x /= np.sqrt(fan_in)
    elif kind == "box_delta":
        # the box head refines each decoder layer's anchors (six times, the
        # deltas add up): at the fan-in scale the boxes leave the sigmoid's
        # range (cx 0.001), where it hides every error upstream
        x *= 0.1 / np.sqrt(fan_in)
    elif kind in ("scale", "bn_scale"):
        x = 1.0 + 0.1 * x
    elif kind == "bn_branch_scale":
        x = 0.2 * (1.0 + 0.1 * x)
    elif kind == "bias":
        x *= 0.1
    return x.astype(np.float32)


def weight_set(seed: int = SEED) -> Dict[str, torch.Tensor]:
    """The seeded weights in the reference state_dict layout, fp32 on the CPU."""
    model = meta_model()
    kinds = _kinds(model)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(_draw(kinds[k], shapes[k], rng)) for k in sorted(shapes)}


def checksum(sd: Dict[str, torch.Tensor]) -> str:
    """sha256 over the keys, shapes and fp32 bytes, in sorted key order."""
    h = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k].detach().cpu().contiguous()
        h.update(f"{k}{tuple(v.shape)}".encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


def clip(t: int, seed: int) -> np.ndarray:
    """uint8 [t, 240, 320, 3]: a colour that changes from frame to frame under
    pixel noise. Frames of noise alone give every frame the same outputs at
    random weights, and every span is then decided by a rounding."""
    rng = np.random.RandomState(seed)
    phase = rng.uniform(0, 2 * np.pi, 3)
    colour = 128 + 120 * np.sin(2 * np.pi * np.arange(t)[:, None] / t * np.array([1, 2, 3])
                                + phase)
    frames = colour[:, None, None, :] + rng.normal(0, 30, (t, *FRAME_HW, 3))
    return np.clip(frames, 0, 255).astype(np.uint8)


def requests(spec, seed: int = SEED) -> List[Tuple[np.ndarray, str, None]]:
    """(frames uint8 [T, 240, 320, 3], sentence, None) per (T, sentence) of
    ``spec`` (SERVED or SMALL)."""
    return [(clip(t, seed + 1 + i), text, None) for i, (t, text) in enumerate(spec)]


def train_sample(seed: int = SEED) -> Dict:
    """One clip with a seeded GT span and boxes (normalized cxcywh), without
    its transform plan (each package plans it with its own transforms)."""
    rng = np.random.RandomState(seed + 100)
    s = int(rng.randint(0, TRAIN_FRAMES // 2))
    e = int(rng.randint(s + 1, TRAIN_FRAMES))
    actioness = np.zeros(TRAIN_FRAMES, np.float32)
    actioness[s: e + 1] = 1.0
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (e - s + 1, 2)),
                            rng.uniform(0.1, 0.4, (e - s + 1, 2))], -1).astype(np.float32)
    return {"frames_u8": clip(TRAIN_FRAMES, seed + 50), "text": TRAIN_TEXT,
            "actioness": actioness, "boxes_cxcywh": boxes}


def train_batch(cfg, seed: int = SEED):
    """The train step's RawVideoBatch and targets (numpy), through the eval
    transform's plan (nothing random) and build_raw_batch."""
    sample = dict(train_sample(seed))
    plan, _, text = build_transforms(cfg).plan(FRAME_HW, np.zeros((0, 4), np.float32),
                                               sample["text"])
    sample.update(plan=plan, text=text)
    raw, targets, _ = build_raw_batch([sample], TRAIN_FRAMES, build_tokenizer(cfg),
                                      cfg.INPUT.MAX_QUERY_LEN)
    return raw, targets


def grad_directions(seed: int = SEED) -> Dict[str, np.ndarray]:
    """A seeded unit vector per parameter (sorted name order), the direction
    each parameter's gradient is projected on."""
    rng = np.random.RandomState(seed + 200)
    out = {}
    for k, p in sorted(meta_model().named_parameters()):
        u = rng.standard_normal(tuple(p.shape))
        out[k] = (u / np.linalg.norm(u)).astype(np.float32)
    return out


def load_fixture(fixture_dir: str = FIXTURE):
    """(arrays, meta) of scripts/torch_full_scale_fixture.py's output."""
    with np.load(os.path.join(fixture_dir, "jax.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(fixture_dir, "meta.json")) as f:
        return arrays, json.load(f)


# --------------------------------------------------------------------------
# the port's side: run, read and compare
# --------------------------------------------------------------------------

# raw outputs, per-frame boxes: |port - jax| <= ATOL + RTOL |jax| elementwise
# (tests/test_full_scale_parity.py's tolerance at the published scale)
ATOL, RTOL = 5e-4, 1e-3
# the train step: each loss term within LOSS_RTOL of JAX's; each parameter's
# gradient norm and its projection on a seeded unit direction within
# GRAD_RTOL x max(its JAX norm, GRAD_FLOOR x its optimizer group's norm): a
# leaf whose gradient is below a thousandth of its group's is read against
# the group's scale (an exact-zero gradient leaves rounding noise in both)
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-3, 1e-3
# bf16 raw outputs: relative L2 error to JAX fp32 within MULTIPLE x the
# reference bf16 error + FLOOR (tests/test_torch_bf16.py's M and F); the
# reference is the farther of JAX bf16's two compilations, or, where the
# port's own plain bf16 route rounds farther, that route's (bf16_errors)
BF16_MULTIPLE, BF16_FLOOR = 2.0, 2e-4
# a span is held equal where JAX's margin exceeds SPAN_MARGIN x the row's
# max |d pred_sted| (span_rows)
SPAN_MARGIN = 8.0


def flatten(out: Dict) -> Dict[str, np.ndarray]:
    """STCATNet's outputs as flat fp32 arrays: pred_boxes, pred_sted,
    pred_actioness, weights, aux_<i>/<key>."""
    def arr(v):
        return np.asarray(v.detach().float().cpu() if isinstance(v, torch.Tensor) else v,
                          np.float32)

    flat = {k: arr(v) for k, v in out.items() if k != "aux_outputs"}
    for i, aux in enumerate(out.get("aux_outputs", ())):
        flat.update({f"aux_{i}/{k}": arr(v) for k, v in aux.items()})
    return flat


def answers(results, frame_valid) -> Dict[str, np.ndarray]:
    """predict_batch's answers as arrays: per request its span and its boxes
    in frame-id order, with the frame mask of the batch it ran (rows [0, R)
    the requests' even-frame streams, [R, 2R) their odd ones)."""
    flat = {"frame_valid": np.asarray(frame_valid, bool)}
    for i, r in enumerate(results):
        fids = sorted(r["boxes"])
        flat[f"request_{i}/span"] = np.asarray(r["span"], np.int64)
        flat[f"request_{i}/frame_ids"] = np.asarray(fids, np.int64)
        flat[f"request_{i}/boxes"] = np.asarray([r["boxes"][f] for f in fids], np.float32)
    return flat


def serve(pred: GroundingPredictor, reqs) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(predict_batch's answers, every raw output of the eval forward on the
    batch predict_batch prepares for the same requests)."""
    results = pred.predict_batch(reqs)
    raw, _, _ = pred.prepare(reqs)
    cfg = pred.cfg
    with torch.inference_mode():
        batch = preprocess(pred.place(raw), tuple(cfg.INPUT.PIXEL_MEAN),
                           tuple(cfg.INPUT.PIXEL_STD))
        out = flatten(pred.model.eval()(batch))
    return answers(results, raw.frame_valid), out


@contextlib.contextmanager
def stage_rms(model: nn.Module):
    """Records each stage's output rms (the stem, the last block of each
    ResNet stage, the text encoder, the cross-modal encoder, both decoders)
    on the first forward inside the block: {name: rms}."""
    names = ["vis_encoder.0.body.bn1"] + [
        f"vis_encoder.0.body.layer{i}.{len(getattr(model.vis_encoder[0].body, f'layer{i}')) - 1}"
        for i in range(1, 5)] + ["text_encoder", "ground_encoder.encoder",
                                 "ground_decoder.decoder", "ground_decoder.temp_decoder"]
    mods, rms, hooks = dict(model.named_modules()), {}, []

    def hook(name):
        def record(mod, inp, out):
            x = out[0] if isinstance(out, tuple) else out
            rms.setdefault(name, x.float().pow(2).mean().sqrt().item())
        return record

    for n in names:
        hooks.append(mods[n].register_forward_hook(hook(n)))
    try:
        yield rms
    finally:
        for h in hooks:
            h.remove()


def output_errors(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                  atol: float = ATOL, rtol: float = RTOL) -> Dict[str, Tuple[float, float]]:
    """{key: (max |got - want|, max |got - want| / (atol + rtol |want|))}; a
    ratio above 1 fails."""
    if set(got) != set(want):
        raise AssertionError(f"output keys differ: {sorted(set(got) ^ set(want))}")
    out = {}
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if g.shape != w.shape:
            raise AssertionError(f"{k}: shape {g.shape} != {w.shape}")
        diff = np.abs(g - w)
        out[k] = (float(diff.max()), float((diff / (atol + rtol * np.abs(w))).max()))
    return out


def span_rows(got_sted: np.ndarray, want_sted: np.ndarray, frame_valid: np.ndarray):
    """Per forward row: (JAX's span, its margin (torch_learning.span_margin),
    the port's span, max |got - want| of the row's pred_sted over its valid
    frames, whether the outputs fix the span). A logit moved by at most d
    moves a log-softmax by at most 2d and a pair's
    margin by at most 8d: where JAX's margin exceeds SPAN_MARGIN x d, the
    row's span must be JAX's; below that, agreeing outputs may decide it
    either way."""
    rows = []
    for g, w, fv in zip(got_sted, want_sted, frame_valid):
        fv = torch.tensor(fv, dtype=torch.bool)
        span, margin = span_margin(torch.tensor(w, dtype=torch.float32), fv)
        got = span_margin(torch.tensor(g, dtype=torch.float32), fv)[0]
        d = float(np.abs(np.asarray(g, np.float64) - w)[fv.numpy()].max())
        rows.append((span, margin, got, d, margin > SPAN_MARGIN * d))
    return rows



def answer_misses(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                  got_sted: np.ndarray, want_sted: np.ndarray) -> Tuple[List[str], List[str]]:
    """(misses, notes): the batch's frame mask and every request's frame ids
    equal, boxes within ATOL / RTOL, and each request's span equal wherever
    both of its rows' spans are fixed by the outputs (span_rows); a span
    that is not is noted with its margins instead."""
    missed, notes = [], []
    for k in want:
        if k.endswith(("frame_valid", "/frame_ids")) and not np.array_equal(got[k], want[k]):
            missed.append(f"{k}: {got[k].tolist()} != {want[k].tolist()}")
    boxes = {k: v for k, v in want.items() if k.endswith("/boxes")}
    for k, (err, ratio) in output_errors({k: got[k] for k in boxes}, boxes).items():
        if not ratio <= 1.0:
            missed.append(f"{k}: max |d| {err:.3e} px, {ratio:.3f} x the limit")
    rows = span_rows(got_sted, want_sted, want["frame_valid"])
    lanes = len(rows) // 2
    for k in (k for k in want if k.endswith("/span")):
        i = int(k.split("/")[0].split("_")[1])
        pair = [rows[i], rows[lanes + i]]
        fixed = all(r[4] for r in pair)
        if np.array_equal(got[k], want[k]) and fixed:
            continue
        detail = "; ".join(f"row {j}: JAX span {r[0]} margin {r[1]:.3e}, port {r[2]}, "
                           f"|d sted| {r[3]:.3e}" for j, r in zip((i, lanes + i), pair))
        if fixed:
            missed.append(f"{k}: {got[k].tolist()} != {want[k].tolist()} ({detail})")
        else:
            notes.append(f"{k}: {got[k].tolist()} vs {want[k].tolist()}, decided by less "
                         f"than the outputs' agreement ({detail})")
    return missed, notes


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def bf16_errors(got: Dict[str, np.ndarray], arrays: Dict[str, np.ndarray],
                plain: Dict[str, np.ndarray]) -> Dict[str, Tuple[float, float, float, float]]:
    """Per raw output: (``got``'s relative L2 error to JAX fp32, JAX bf16's
    own error (the farther of its two compilations), ``plain``'s (the port's
    bf16 route without the kernels), the limit BF16_MULTIPLE x the larger
    of those two + BF16_FLOOR). The port adds a Linear's bias inside the
    GEMM where flax rounds the product first (a settled difference): at the
    published scale that alone takes one output to 2.02 x JAX's error on the
    CPU (PERF.md §6), so the kernels are held to the port's own rounding
    where it is the farther."""
    out = {}
    for k, v in got.items():
        want = arrays[f"serve/{k}"]
        e_jax = max(rel_l2(arrays[f"{c}/{k}"], want) for c in ("bf16", "bf16_strict"))
        e_plain = rel_l2(plain[k], want)
        out[k] = (rel_l2(v, want), e_jax, e_plain,
                  BF16_MULTIPLE * max(e_jax, e_plain) + BF16_FLOOR)
    return out


def fixture_outputs(arrays: Dict[str, np.ndarray], prefix: str = "serve/") -> Dict[str, np.ndarray]:
    """The fixture's raw outputs under ``prefix`` (answers excluded)."""
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)
            and not k[len(prefix):].startswith(("request_", "frame_valid"))}


def fixture_answers(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The fixture's predict_batch answers and batch frame mask."""
    return {k[len("serve/"):]: v for k, v in arrays.items()
            if k.startswith(("serve/request_", "serve/frame_valid"))}


def train_step(cfg, model: nn.Module, dirs: Dict[str, np.ndarray]):
    """One forward+backward of the train batch (the port's accumulate_grads,
    GRAD_ACCUM 1): ({loss term: value}, {parameter: [grad norm, projection on
    dirs[parameter]]}); a parameter without a gradient reads [0, 0]. The
    gradients are zeroed afterwards."""
    dev = next(model.parameters()).device
    opt = make_optimizer(cfg, model, num_training_steps=1000)
    raw, targets = train_batch(cfg)
    losses = accumulate_grads(cfg, model, opt, to_device(raw, dev), to_device(targets, dev))
    readings = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            readings[name] = np.zeros(2)
            continue
        g = p.grad.detach().double().cpu().numpy().ravel()
        readings[name] = np.asarray([np.linalg.norm(g), float(np.dot(g, dirs[name].ravel()))])
    opt.zero_grad()
    return {k: float(v) for k, v in losses.items()}, readings


def train_errors(terms: Dict[str, float], readings: Dict[str, np.ndarray],
                 arrays: Dict[str, np.ndarray]):
    """(worst loss term (rel error / LOSS_RTOL, name), worst leaf (error /
    limit, name, which), misses): a ratio above 1 misses."""
    cfg = train_cfg()
    labels = label_params(cfg, meta_model(cfg))
    want_terms = {k[len("train/loss/"):]: float(v) for k, v in arrays.items()
                  if k.startswith("train/loss/")}
    want = {k[len("train/grad/"):]: v for k, v in arrays.items() if k.startswith("train/grad/")}
    if set(terms) != set(want_terms) or set(readings) != set(want):
        raise AssertionError("the train step's loss terms or parameters differ from the fixture's")
    misses = []
    loss = []
    for k, w in want_terms.items():
        r = abs(terms[k] - w) / abs(w) / LOSS_RTOL
        loss.append((r, k))
        if not r <= 1.0:
            misses.append(f"loss term {k}: {terms[k]:.7g} vs JAX {w:.7g}")
    groups: Dict[str, float] = {}
    for k, (n, _) in want.items():
        groups[labels[k]] = groups.get(labels[k], 0.0) + n * n
    leaves = []
    for k, (n, proj) in want.items():
        limit = GRAD_RTOL * max(n, GRAD_FLOOR * np.sqrt(groups[labels[k]]))
        for which, got, ref in (("norm", readings[k][0], n), ("projection", readings[k][1], proj)):
            r = abs(got - ref) / limit if limit > 0 else (0.0 if got == ref else np.inf)
            leaves.append((r, k, which))
            if not r <= 1.0:
                misses.append(f"{k} gradient {which}: {got:.7g} vs JAX {ref:.7g} "
                              f"(limit {limit:.3g})")
    return max(loss), max(leaves), misses
