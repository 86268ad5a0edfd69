"""The readings behind chip_smoke.py phase 10's bf16 checks (PERF.md §6).

On a machine with the card, from the repository root:

    python scripts/torch_learning_readings.py [--linear flax|bf16-only|single]
                                              [--weights-out FILE]

runs phase 10 (``chip_smoke.learning_phase``: the learning proof's training,
then its routes, spans, sted margins and checks; a raised check is printed,
not re-raised), and with the trained weights: every K1 call of one bf16
evaluation against float64 (the kernel, the plain version on the card and on
the CPU, and the exact output rounded to bf16 alone), then planted faults
(each K1 call of a forward zeroed or halved) with their drift from the fp32
validation. ``--linear`` picks how a ``Linear`` adds its bias: "single"
(this tree: ``F.linear(x, w, b)``, the biased sum rounded once), "flax"
(the product rounded, then the bias added in its dtype, as a flax ``Dense``
does, at every dtype) or "bf16-only" (that in bf16 alone).
``--weights-out`` saves the trained state_dict.

On the CPU, with the JAX package importable:

    JAX_PLATFORMS=cpu python scripts/torch_learning_readings.py --evaluate FILE

evaluates saved weights in both packages, fp32 and bf16 each, with each
forward row's span and sted margin and the largest |delta pred_sted| between
the packages' bf16 rows.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import types

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import torch_learning as tl  # noqa: E402
from stcat_tpu_torch.train.loop import run_validation  # noqa: E402

_LINEAR = F.linear


def _flax(x, w, b=None):
    return _LINEAR(x, w) if b is None else _LINEAR(x, w) + b


def _flax_bf16(x, w, b=None):
    return _LINEAR(x, w, b) if x.dtype == torch.float32 else _flax(x, w, b)


# every biased Linear of the model goes through torch.nn.functional.linear
LINEAR = {"single": _LINEAR, "flax": _flax, "bf16-only": _flax_bf16}


def rows_line(rows) -> str:
    spans = [tl.span_margin(r["pred_sted"], r["frame_valid"]) for r in rows]
    return "; ".join(f"row {i} span {span} margin {margin:.4f}"
                     for i, (span, margin) in enumerate(spans))


def k1_against_float64(cfg, state) -> None:
    """Each K1 call of one bf16 evaluation on the card, its inputs replayed
    through the kernel and the plain versions, against float64."""
    from stcat_tpu_torch.kernels import attention as kattn

    calls, saved = [], kattn.flash_attention

    def keep(q, k, v, bias):
        calls.append(tuple(t.detach().clone() for t in (q, k, v, bias)))
        return saved(q, k, v, bias)

    kattn.flash_attention = keep
    try:
        tl.evaluate(cfg, state, "cuda", "bfloat16")
    finally:
        kattn.flash_attention = saved

    def rel(a, b):
        return ((a.double() - b).norm() / b.norm()).item()

    with torch.inference_mode():
        for i, (q, k, v, bias) in enumerate(calls):
            logits = torch.einsum("bqd,bkd->bqk", q.double() / math.sqrt(q.shape[-1]),
                                  k.double()) + bias[:, None, :].double()
            exact = torch.einsum("bqk,bkd->bqd", torch.softmax(logits, -1), v.double())
            kernel = kattn._launch(q, k, v, bias)
            plain = kattn.attention_plain(q, k, v, bias)
            cpu = kattn.attention_plain(*(t.cpu() for t in (q, k, v, bias)))
            print(f"  K1 call {i}: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}, "
                  f"{int((bias < -1e29).sum())} masked keys; relative error to float64: kernel "
                  f"{rel(kernel, exact):.3e}, plain on the card {rel(plain, exact):.3e}, plain "
                  f"on the CPU {rel(cpu, exact.cpu()):.3e}, the exact output rounded to bf16 "
                  f"{rel(exact.to(torch.bfloat16), exact):.3e}")


def card(args) -> None:
    import chip_smoke as cs
    from stcat_tpu_torch.kernels import _build

    F.linear = LINEAR[args.linear]
    print(cs.nvidia_smi_line(), f"torch {torch.__version__}, Linear bias add: {args.linear}")
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    overfit = tl.overfit

    def readings(out) -> None:
        if args.weights_out:
            torch.save({n: v.detach().cpu() for n, v in out["state"].model.state_dict().items()},
                       args.weights_out)
        print("K1 against float64, one bf16 evaluation of the trained weights:")
        k1_against_float64(out["cfg"], out["state"])
        print("planted K1 faults, bf16 on the card, drift from the fp32 validation:")
        for call in range(cs.K1_PER_LEARNING_FORWARD):
            for scale in (0.0, 0.5):
                with cs.planted_k1(call, scale):
                    r, rows = tl.evaluate(out["cfg"], out["state"], "cuda", "bfloat16")
                d = tl.drifts(r, out["res"])
                print(f"  call {call} x {scale}: {cs._metrics_line(r)}; vIoU drift "
                      f"{d['viou_drift']:.4f}, tIoU drift {d['tiou_drift']:.4f}; {rows_line(rows)}")

    def keeping(*a, **k):
        out = overfit(*a, **k)
        # the readings run inside the phase, while its data directory exists,
        # past its counting validation and with its launch counts restored
        counts = {c: c.count for c in cs.KERNEL_COUNTERS.values()}
        counting, tl.run_validation = tl.run_validation, run_validation
        try:
            readings(out)
        finally:
            for counter, count in counts.items():
                counter.count = count
            tl.run_validation = counting
        return out

    tl.overfit = keeping
    try:
        cs.learning_phase()
    except AssertionError as e:
        print(f"phase 10 raised: {e}")
    finally:
        tl.overfit = overfit


def evaluate(args) -> None:
    import test_torch_learning as ttl
    from stcat_tpu_torch.models import build_model
    import chip_smoke as cs

    state_dict = torch.load(args.evaluate)
    extra = list(cs.LEARNING_OPTS)
    cfg = tl.learning_cfg(tempfile.mkdtemp(), extra)
    model = build_model(cfg, "cpu", seed=cfg.SEED)
    model.load_state_dict(state_dict)
    state = types.SimpleNamespace(model=model, ema=None, step=tl.ITERS)
    res, rows = {}, {}
    for dtype in ("float32", "bfloat16"):
        res["JAX", dtype], rows["JAX", dtype] = ttl.jax_evaluate(tempfile.mkdtemp(), state_dict,
                                                                dtype, extra)
        res["port", dtype], rows["port", dtype] = tl.evaluate(cfg, state, "cpu", dtype)
    for (pkg, dtype), r in res.items():
        print(f"{pkg} {dtype}: {cs._metrics_line(r)}; {rows_line(rows[pkg, dtype])}")
    for pkg in ("JAX", "port"):
        d = tl.drifts(res[pkg, "bfloat16"], res[pkg, "float32"])
        print(f"{pkg} bf16 drift: vIoU {d['viou_drift']:.4f}, tIoU {d['tiou_drift']:.4f}")
    gaps = [(p["pred_sted"] - j["pred_sted"])[j["frame_valid"]].abs().max().item()
            for p, j in zip(rows["port", "bfloat16"], rows["JAX", "bfloat16"])]
    print("largest |delta pred_sted| between the packages' bf16 rows: "
          + ", ".join(f"{g:.4f}" for g in gaps))
    print("fp32 metrics equal to 4 digits:",
          all(abs(v - res["port", "float32"][k]) < 5e-5 for k, v in res["JAX", "float32"].items()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--linear", choices=sorted(LINEAR), default="single")
    ap.add_argument("--weights-out", default="")
    ap.add_argument("--evaluate", default="", help="saved weights to evaluate on the CPU")
    args = ap.parse_args()
    if args.evaluate:
        evaluate(args)
    elif torch.cuda.is_available():
        card(args)
    else:
        sys.exit("torch_learning_readings: no card (pass --evaluate FILE for the CPU readings)")


if __name__ == "__main__":
    main()
