"""Readings behind the training-gradient checks' limits, at both fresh-weight
draws of the port: the JAX package's distributions (``build_model``) and the
earlier untruncated normal (tests/torch_grad_check.py::untruncated_init).

1. The tiny model of tests/test_torch_cuda.py's gradient test: each route's
   relative L2 error to the float64 CPU reference per gradient tensor (the
   CPU's and the card's plain versions and the card's kernels, fp32), with
   cuDNN free to choose its algorithms and held to deterministic ones; the
   earlier check (card vs CPU at atol 2e-4 / rtol 1e-3) on each route; and
   planted K2 faults against both checks.
2. chip_smoke.py phase 4's comparison at full width: the fp32 kernel and
   plain routes, the bf16 kernel and plain routes' errors to the fp32 plain
   route per K2-fed leaf, the earlier bf16 check (||kernel - plain|| /
   ||plain|| <= 0.15), and planted K2 faults against both checks.

Needs a card:

    python scripts/torch_grad_readings.py [--out chiprun_out/grad_readings.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import chip_smoke as cs  # noqa: E402
import torch_grad_check as gc  # noqa: E402
from stcat_tpu_torch.config import merge_from_list  # noqa: E402
from stcat_tpu_torch.core.batch import to_device  # noqa: E402
from stcat_tpu_torch.kernels import _build  # noqa: E402
from stcat_tpu_torch.train.optimizer import make_optimizer  # noqa: E402

DRAWS = ("jax", "untruncated")
# the tiny model's draws: seed 6 of the JAX distributions is one where the
# CPU's own fp32 gradients miss float64 by a median 6.6e-4 per tensor
TINY_DRAWS = (("jax", 0), ("untruncated", 0), ("jax", 6))
DEVICE = "cuda"
# the earlier checks: the tiny card test's elementwise card-vs-CPU bound and
# phase 4's bf16 leaf limit
OLD_TINY = {"atol": 2e-4, "rtol": 1e-3}
OLD_LEAF = 1.5e-1
TINY_PLANTS = [dict(call=2, kind="scale", factor=1.01), dict(call=0, kind="scale", factor=1.01),
               dict(call=2, kind="tile")]
FULL_PLANTS = [dict(call=11, kind="tile"), dict(call=6, kind="tile"),
               dict(call=11, kind="scale", factor=1.01), dict(call=11, kind="scale", factor=1.1),
               dict(call=11, kind="scale", factor=1.25)]


def summary(errs: dict, names) -> dict:
    vals = sorted((errs[n], n) for n in names)
    return {"median": vals[len(vals) // 2][0], "largest": [(n, v) for v, n in vals[::-1][:3]]}


def old_tiny_failures(grads: dict, cpu: dict) -> list:
    return [n for n, g in grads.items() if g is not None and not np.allclose(
        g.numpy(), cpu[n].numpy(), **OLD_TINY)]


def tiny_readings(draw: str, seed: int) -> dict:
    cfg = gc.train_cfg()
    batch, targets = gc.train_arrays()
    _, ref = gc.training_grads(cfg, gc.fresh_model(cfg, "cpu", draw, seed).double(), batch, targets,
                               torch.float64)
    _, cpu = gc.training_grads(cfg, gc.fresh_model(cfg, "cpu", draw, seed), batch, targets)
    errs = {"cpu": gc.route_errors(cpu, ref)}
    out = {}
    cudnn = torch.backends.cudnn
    for det in (False, True):
        cudnn.deterministic = det
        with cs.plain_kernels():
            _, plain = gc.training_grads(cfg, gc.fresh_model(cfg, DEVICE, draw, seed), batch, targets)
        _, kern = gc.training_grads(cfg, gc.fresh_model(cfg, DEVICE, draw, seed), batch, targets)
        e = dict(errs, **{"card plain": gc.route_errors(plain, ref),
                          "card kernels": gc.route_errors(kern, ref)})
        names = [n for n in e["cpu"] if max(x[n] for x in e.values()) < 1]
        further = sorted(((e["card plain"][n] / max(e["cpu"][n], 1e-300), n) for n in names),
                         reverse=True)
        out[f"deterministic={det}"] = {
            "routes": {r: summary(x, names) for r, x in e.items()},
            "zero_gradient_tensors": len(e["cpu"]) - len(names),
            "card_plain_over_cpu_largest": [(n, v) for v, n in further[:8]],
            "card_plain_over_cpu_above_3": sum(v > 3 for v, _ in further),
            "kernels_over_larger_plain_largest": sorted(
                ((e["card kernels"][n] / max(e["cpu"][n], e["card plain"][n], 1e-300), n)
                 for n in names), reverse=True)[:5],
            "failures_at_limits": gc.check_failures(e["card kernels"], [e["cpu"], e["card plain"]]),
            "old_check_failures": {"card kernels": len(old_tiny_failures(kern, cpu)),
                                   "card plain": len(old_tiny_failures(plain, cpu))},
            "per_tensor": {n: {r: x[n] for r, x in e.items()} for n in e["cpu"]},
        }
        errs_det = e
    cudnn.deterministic = False
    plants = []
    for plant in TINY_PLANTS:
        with gc.planted_k2_fault(**plant) as calls:
            _, bad = gc.training_grads(cfg, gc.fresh_model(cfg, DEVICE, draw, seed), batch, targets)
        new = gc.check_failures(gc.route_errors(bad, ref), [errs_det["cpu"], errs_det["card plain"]])
        plants.append({"plant": plant, "calls": calls, "new_check_failures": len(new),
                       "new_worst": new[:3], "old_check_failures": len(old_tiny_failures(bad, cpu))})
    out["plants"] = plants
    return out


def full_readings(draw: str) -> dict:
    cfg = cs.recipe_cfg("MODEL.STCAT.DROPOUT", "0.0", "TPU.GRAD_ACCUM", str(cs.ACCUM),
                        "SOLVER.WARMUP_PROP", "0.0")
    raw, targets = cs._train_batch(cfg)
    raw, targets = to_device(raw, DEVICE), to_device(targets, DEVICE)
    out = {}
    cfg32 = merge_from_list(cfg, ["TPU.COMPUTE_DTYPE", "float32"])
    model = gc.fresh_model(cfg32, DEVICE, draw)
    opt = make_optimizer(cfg32, model, num_training_steps=1000)
    loss_k, norms_k, leaf_k = cs.step_grads(cfg32, model, opt, raw, targets)
    loss_p, norms_p, ref = cs.step_grads(cfg32, model, opt, raw, targets, plain=True)
    fp32 = cs.leaf_errors(leaf_k, ref)
    norms32 = norms_p
    out["float32"] = {"loss_rel": abs(loss_k - loss_p) / abs(loss_p),
                      "grad_norm_rel": {g: abs(norms_k[g] - norms_p[g]) / norms_p[g]
                                        for g in norms_k},
                      "leaf_rel": summary(fp32, fp32)}
    del model, opt
    torch.cuda.empty_cache()
    model = gc.fresh_model(cfg, DEVICE, draw)
    opt = make_optimizer(cfg, model, num_training_steps=1000)
    loss_k, norms_k, leaf_k = cs.step_grads(cfg, model, opt, raw, targets)
    loss_p, norms_p, leaf_p = cs.step_grads(cfg, model, opt, raw, targets, plain=True)
    err_k, err_p = cs.leaf_errors(leaf_k, ref), cs.leaf_errors(leaf_p, ref)
    old = cs.leaf_errors(leaf_k, leaf_p)
    ratio = sorted(((err_k[n] / err_p[n], n) for n in err_k if err_p[n] > 0), reverse=True)
    out["bfloat16"] = {
        "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
        "grad_norm_rel": {g: abs(norms_k[g] - norms_p[g]) / norms_p[g] for g in norms_k},
        "grad_norm_to_fp32": {g: (abs(norms_k[g] - norms32[g]) / norms32[g],
                                  abs(norms_p[g] - norms32[g]) / norms32[g]) for g in norms_k},
        "old_leaf_rel": summary(old, old), "kernels_to_fp32": summary(err_k, err_k),
        "plain_to_fp32": summary(err_p, err_p),
        "kernels_over_plain_largest": [(n, v) for v, n in ratio[:5]],
        "kernels_over_plain_median": ratio[len(ratio) // 2][0],
        "failures_at_limits": cs.leaf_check(err_k, err_p, cs.STEP_TOL["bfloat16"]),
        "per_leaf": {n: {"kernels": err_k[n], "plain": err_p[n], "old": old[n]} for n in err_k},
    }
    plants = []
    for plant in FULL_PLANTS:
        with gc.planted_k2_fault(every=cs.K1_PER_MICROBATCH, **plant) as calls:
            leaf_x = cs.step_grads(cfg, model, opt, raw, targets)[2]
        err_x = cs.leaf_errors(leaf_x, ref)
        old_x = cs.leaf_errors(leaf_x, leaf_p)
        worst = max(old_x, key=old_x.get)
        plants.append({
            "plant": plant, "calls": calls[:1] + [len(calls)],
            "old_check": {"largest": (worst, old_x[worst]), "fails": old_x[worst] > OLD_LEAF},
            "new_check_failures": cs.leaf_check(err_x, err_p, cs.STEP_TOL["bfloat16"])[:4],
            "kernels_over_plain_largest": max((err_x[n] / err_p[n], n) for n in err_x
                                              if err_p[n] > 0)})
    out["plants"] = plants
    return out


def brief(tree):
    """The tree without its per-tensor tables."""
    if isinstance(tree, dict):
        return {k: brief(v) for k, v in tree.items() if k not in ("per_tensor", "per_leaf")}
    if isinstance(tree, list):
        return [brief(v) for v in tree]
    return tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "grad_readings.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), torch.__version__, torch.version.cuda, flush=True)
    _build.build_all()
    res = {}
    for draw, seed in TINY_DRAWS:
        t0 = time.time()
        key = f"tiny {draw} seed {seed}"
        res[key] = tiny_readings(draw, seed)
        print(f"{key}: {time.time() - t0:.1f} s", json.dumps(brief(res[key]), default=str),
              flush=True)
    for draw in DRAWS:
        t0 = time.time()
        res[f"full {draw}"] = full_readings(draw)
        print(f"full {draw}: {time.time() - t0:.1f} s",
              json.dumps(brief(res[f"full {draw}"]), default=str), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
