"""The JAX package's outputs for the published model, for chip_smoke.py phase 11.

    JAX_PLATFORMS=cpu python scripts/torch_full_scale_fixture.py [--out DIR]

Runs the JAX package on the CPU (TPU.ATTENTION_IMPL and TPU.CONV_IMPL "xla":
the plain references of its Pallas kernels) with the seeded weights and
inputs of tests/torch_full_scale.py, and writes DIR/jax.npz and
DIR/meta.json (default tests/assets/torch_full_scale/):

  serve/*    the served batch through GroundingPredictor.predict_batch (the
             seeded weights from a .pth, two requests, max_batch 2): each
             request's span and per-frame boxes, and the raw outputs of the
             eval forward on the same prepared batch (pred_boxes, pred_sted,
             pred_actioness, weights, every aux_outputs entry), fp32;
  bf16/*, bf16_strict/*
             the same raw outputs in bf16 compute, compiled with XLA's
             default excess precision and with it off (every bf16 rounding
             the JAX source writes kept);
  train/*    one fp32 train step's loss terms (loss and jax.grad, GRAD_ACCUM
             1) and, for every parameter in the port's state_dict names, its
             gradient's L2 norm and its projection on a seeded unit direction
             (tests/torch_full_scale.py::grad_directions).

meta.json holds the seeds, shapes and cuts, the package versions, the weight
set's checksum and each run's seconds. The port and chip_smoke.py import no
JAX: this script is how the card is held to the JAX package.
tests/test_torch_full_scale.py imports its functions (and, marked slow,
rebuilds the fixture and holds it to the committed one).
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import tempfile
import time
from typing import Dict

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("HF_HUB_OFFLINE", "1")
# the test suite's CPU platform (tests/conftest.py), so a rebuild under pytest
# compiles the same programs
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_full_scale as fs  # noqa: E402
from stcat_tpu.config import default_config, merge_from_file, merge_from_list  # noqa: E402
from stcat_tpu.data.batching import build_raw_batch  # noqa: E402
from stcat_tpu.data.tokenize import HashTokenizer  # noqa: E402
from stcat_tpu.data.transforms import build_transforms  # noqa: E402
from stcat_tpu.models import STCATNet  # noqa: E402
from stcat_tpu.serve import GroundingPredictor  # noqa: E402
from stcat_tpu.train.criterion import build_weight_dict, video_stg_loss  # noqa: E402
from stcat_tpu.train.step import _as_video_batch  # noqa: E402
from stcat_tpu_torch.convert import from_jax_variables  # noqa: E402

STRICT = {"xla_allow_excess_precision": False}


def jax_cfg(dtype: str = "float32", train: bool = False):
    """tests/torch_full_scale.py's config in the JAX package, on the plain
    references of its Pallas kernels."""
    cfg = merge_from_file(default_config(), fs.RECIPE)
    opts = list(fs.OPTS) + ["TPU.COMPUTE_DTYPE", dtype, "TPU.ATTENTION_IMPL", "xla",
                            "TPU.CONV_IMPL", "xla"]
    return merge_from_list(cfg, opts + list(fs.TRAIN_OPTS if train else ()))


def predictor(cfg, weights: str, max_batch: int) -> GroundingPredictor:
    pred = GroundingPredictor(cfg, weights=weights, max_batch=max_batch)
    # the hash tokenizer whatever tokenizer files the host has (the port reads
    # only MODEL.TEXT_MODEL.LOCAL_PATH)
    pred.tokenizer = HashTokenizer(cfg.MODEL.TEXT_MODEL.VOCAB_SIZE)
    return pred


def serve(pred: GroundingPredictor, requests):
    """predict_batch's answers and the prepared batch its forward took."""
    seen = []
    fwd = pred.fwd

    def capture(params, constants, batch):
        seen.append(batch)
        return fwd(params, constants, batch)

    pred.fwd = capture
    try:
        results = pred.predict_batch(requests)
    finally:
        pred.fwd = fwd
    return results, jax.device_get(seen[-1])


def raw_outputs(cfg, params, constants, batch, compiler_options=None) -> Dict[str, np.ndarray]:
    """Every output of STCATNet's eval forward on a prepared raw batch, flat:
    pred_boxes, pred_sted, pred_actioness, weights, aux_<i>/<key>."""
    model = STCATNet(cfg)

    def fwd(p, c, b):
        return model.apply({"params": p, "constants": c}, _as_video_batch(cfg, b),
                           deterministic=True)

    lowered = jax.jit(fwd).lower(params, constants, batch)
    out = jax.device_get(lowered.compile(compiler_options=compiler_options)(
        params, constants, batch))
    return fs.flatten(out)


def train_inputs(cfg):
    """tests/torch_full_scale.py's train sample through the JAX package's
    transform plan and build_raw_batch."""
    sample = dict(fs.train_sample())
    plan, _, text = build_transforms(cfg, is_train=False).plan(
        fs.FRAME_HW, np.zeros((0, 4), np.float32), sample["text"], np.random.default_rng(0))
    sample.update(plan=plan, text=text)
    raw, targets, _ = build_raw_batch([sample], fs.TRAIN_FRAMES,
                                      HashTokenizer(cfg.MODEL.TEXT_MODEL.VOCAB_SIZE),
                                      cfg.INPUT.MAX_QUERY_LEN)
    return raw, targets


def train_step(cfg, params, constants, raw, targets):
    """The JAX step's loss and jax.grad at GRAD_ACCUM 1 (make_train_step's
    global_loss, every dropout 0): (loss terms, gradients in the port's
    state_dict names)."""
    model, weights, s = STCATNet(cfg), build_weight_dict(cfg), cfg.SOLVER
    b = targets.box_valid.shape[0]
    num_boxes = jnp.maximum(jnp.asarray(targets.box_valid).sum().astype(jnp.float32) / b, 1.0)

    def loss(p):
        batch = _as_video_batch(cfg, raw)
        out = model.apply({"params": p, "constants": constants}, batch, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        losses = video_stg_loss(out, targets, batch.frame_valid, num_boxes, sigma=s.SIGMA,
                                eos_coef=s.EOS_COEF, use_attn=s.USE_ATTN,
                                use_actioness=cfg.MODEL.STCAT.USE_ACTION)
        return sum(losses[k] * w for k, w in weights.items() if k in losses), losses

    (total, losses), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    terms = {"loss": float(total), **{k: float(v) for k, v in losses.items()}}
    grads = from_jax_variables(jax.tree_util.tree_map(np.asarray, grads), constants)
    named = dict(fs.meta_model(fs.train_cfg()).named_parameters())
    return terms, {k: v.numpy() for k, v in grads.items() if k in named}


def grad_readings(grads: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """{name: [L2 norm, projection on its unit direction]} (float64), as
    tests/torch_full_scale.py::train_step reads the port's."""
    dirs = fs.grad_directions()
    out = {}
    for k, g in grads.items():
        g = g.astype(np.float64).ravel()
        out[k] = np.asarray([np.linalg.norm(g), float(np.dot(g, dirs[k].ravel()))])
    return out


def build(out_dir: str) -> Dict:
    """Run every JAX side and write out_dir/jax.npz and out_dir/meta.json."""
    secs, arrays = {}, {}
    t = time.time()
    sd = fs.weight_set()
    digest = fs.checksum(sd)
    secs["weights"] = time.time() - t
    with tempfile.TemporaryDirectory(prefix="full_scale_") as tmp:
        path = os.path.join(tmp, "weights.pth")
        torch.save(sd, path)
        del sd
        t = time.time()
        cfg = jax_cfg()
        pred = predictor(cfg, path, max_batch=len(fs.SERVED))
        secs["predictor"] = time.time() - t
        t = time.time()
        results, batch = serve(pred, fs.requests(fs.SERVED))
        secs["serve"] = time.time() - t
    params, constants = pred.params, pred.constants
    del pred
    arrays.update({f"serve/{k}": v for k, v in fs.answers(results, batch.frame_valid).items()})
    t = time.time()
    arrays.update({f"serve/{k}": v for k, v in raw_outputs(cfg, params, constants,
                                                            batch).items()})
    secs["raw_outputs"] = time.time() - t
    for name, options in (("bf16", None), ("bf16_strict", STRICT)):
        t = time.time()
        out = raw_outputs(jax_cfg("bfloat16"), params, constants, batch, options)
        arrays.update({f"{name}/{k}": v for k, v in out.items()})
        secs[name] = time.time() - t
    del batch
    t = time.time()
    tcfg = jax_cfg(train=True)
    raw, targets = train_inputs(tcfg)
    terms, grads = train_step(tcfg, params, constants, raw, targets)
    secs["train"] = time.time() - t
    del params, constants
    arrays.update({f"train/loss/{k}": np.asarray(v, np.float64) for k, v in terms.items()})
    arrays.update({f"train/grad/{k}": v for k, v in grad_readings(grads).items()})

    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, "jax.npz"), **arrays)
    meta = {
        "seed": fs.SEED, "weights_sha256": digest, "config": fs.RECIPE[len(ROOT) + 1:],
        "opts": list(fs.OPTS), "jax_opts": ["TPU.ATTENTION_IMPL", "xla", "TPU.CONV_IMPL", "xla"],
        "cuts": fs.CUTS, "served": [list(r) for r in fs.SERVED],
        "train": {"frames": fs.TRAIN_FRAMES, "resolution": fs.TRAIN_RESOLUTION,
                  "text": fs.TRAIN_TEXT},
        "shapes": {k: list(v.shape) for k, v in arrays.items()
                   if not k.startswith("train/grad/")},
        "seconds": secs,
        "versions": {"python": platform.python_version(), "jax": jax.__version__,
                     "numpy": np.__version__, "torch": torch.__version__},
        "devices": f"{jax.device_count()} x {jax.devices()[0].device_kind}, "
                   f"{os.cpu_count()} cores",
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=fs.FIXTURE)
    meta = build(ap.parse_args(argv).out)
    print(json.dumps(meta["seconds"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
