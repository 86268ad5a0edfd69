"""Drive the PyTorch port (stcat_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is caught):
  1. device: require CUDA, print the card's name and power limit, the torch
     and CUDA versions, and build every kernel (one nvcc per source, in
     parallel);
  2. kernels: each hand-written kernel against its plain PyTorch version at
     the main path's shapes (4 lanes x 64 frames, canvas 448x608, 14x19
     feature grid, L = 26), in bf16 and fp32, with kernel / plain / library
     times and the card's bound for the same work;
  3. serving: the VidSTG R101 recipe at full width (RoBERTa-base, d = 256,
     6/6/6 layers, 448 px) with seeded random weights answers three requests
     through the port's MicroBatcher; every kernel's launch count must rise;
     one served batch is re-run with the kernels swapped for their plain
     versions and the outputs compared.
The line before the last is a JSON object listing every kernel's numbers;
the last line is the device record.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from stcat_tpu_torch.config import default_config, merge_from_file, merge_from_list  # noqa: E402
from stcat_tpu_torch.core.batch import to_device  # noqa: E402
from stcat_tpu_torch.kernels import _build  # noqa: E402
from stcat_tpu_torch.kernels import attention as kattn  # noqa: E402
from stcat_tpu_torch.kernels import bottleneck as kbottle  # noqa: E402
from stcat_tpu_torch.serve import GroundingPredictor, MicroBatcher, eval_forward  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# main path: 2 requests x 2 streams = 4 lanes of 64 frames, 8 heads, d = 256
LANES, FRAMES, HEADS, HW, L = 4, 64, 8, 14 * 19, 26
S = 1 + HW + L  # encoder spatial sequence: frame-CLS + grid + text
M = HW + L      # decoder memory
K1_CASES = [  # name, BH, Sq, Sk, Dk, Dv, launches per served forward
    ("encoder spatial", LANES * FRAMES * HEADS, S, S, 32, 32, 6),
    ("encoder temporal", LANES * HEADS, FRAMES + 1, FRAMES + 1, 32, 32, 6),
    ("spatial-decoder concat cross", LANES * FRAMES * HEADS, 1, M, 64, 32, 6),
    ("time-decoder cross", LANES * FRAMES * HEADS, 1, M, 32, 32, 6),
]
N = LANES * FRAMES
K3_CASES = [  # name, H, W, Cin, P, projection, launches per served forward
    ("layer1 block0", 112, 152, 64, 64, True, 1),
    ("layer1", 112, 152, 256, 64, False, 2),
    ("layer2", 56, 76, 512, 128, False, 3),
    ("layer3", 28, 38, 1024, 256, False, 22),
    ("layer4", 14, 19, 2048, 512, False, 2),
]
# max |kernel - plain| / max(1, max |plain|): fp32 differs only in summation
# order over K <= 9*512 terms; bf16 also rounds p (K1) and x1/y2 (K3) at
# other points than the plain version, ~2 bf16 ulps of the largest output
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# served outputs, kernels vs plain versions, both bf16 end to end: boxes are
# sigmoid outputs in [0, 1] (absolute); sted logits scale with the random
# weights (relative to max |plain|). Starting points: test_full_parity.py's
# bf16 envelope (1.5e-2 boxes, 8e-2 sted).
SERVE_TOL = {"pred_boxes": 1.5e-2, "pred_sted": 8e-2}


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(out: torch.Tensor, ref: torch.Tensor):
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(1.0, ref.float().abs().max().item())


def randn(gen, *shape, dtype, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def new_total():
    return dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err",
                          "ops_ms", "bytes_ms"), 0.0)


def record(total, label, dtype, err, rel, times, flops, nbytes, per_fwd):
    """Check the error, print one shape's line, add it to the kernel's total
    (times weighted by launches per forward, bf16 only)."""
    if not rel <= TOL[dtype]:
        raise AssertionError(f"{label} {dtype}: rel err {rel:.3e} > {TOL[dtype]}")
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    ms, plain_ms, lib_ms = times
    print(f"  {label} {str(dtype):15s}: max_abs_err={err:.3e} rel={rel:.3e} "
          f"(tol {TOL[dtype]}) kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
          f"library={lib_ms:.4f} ms bound={bound:.4f} ms ({by})")
    if dtype == torch.bfloat16:
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                         ("library_ms", lib_ms), ("ops_ms", t_ops), ("bytes_ms", t_bytes)):
            total[key] += per_fwd * val
    total["max_abs_err"] = max(total["max_abs_err"], err)


def check_k1(gen, dtype):
    total = new_total()
    isz = torch.finfo(dtype).bits // 8
    for name, bh, sq, sk, dk, dv, per_fwd in K1_CASES:
        q, k = randn(gen, bh, sq, dk, dtype=dtype), randn(gen, bh, sk, dk, dtype=dtype)
        v = randn(gen, bh, sk, dv, dtype=dtype)
        bias = torch.zeros(bh, sk, device="cuda")
        bias[:, -L // 2:] = -1e30      # padded text tokens
        bias[: bh // 16, :] = -1e30    # fully masked rows: uniform average
        out = kattn.flash_attention(q, k, v, bias)
        ref = kattn.attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        mask = bias[:, None, :].to(dtype)
        times = (time_ms(lambda: kattn.flash_attention(q, k, v, bias), 10),
                 time_ms(lambda: kattn.attention_plain(q, k, v, bias), 10),
                 time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 10))
        flops = 2.0 * bh * sq * sk * (dk + dv)
        nbytes = isz * (bh * sq * dk + bh * sk * dk + bh * sk * dv + bh * sq * dv) + 4 * bh * sk
        record(total, f"K1 {name:30s} BH={bh} Sq={sq} Sk={sk} Dk={dk} Dv={dv}", dtype, err,
               rel, times, flops, nbytes, per_fwd)
        del q, k, v, bias, out, ref
    return total


def _library_bottleneck(x, p: kbottle.BlockWeights, d: int):
    """The cuDNN convolution sequence with fused bias (library yardstick)."""
    dt = x.dtype
    xc = x.permute(0, 3, 1, 2)
    x1 = F.relu(F.conv2d(xc, p.w1.t()[:, :, None, None].to(dt), p.b1.flatten().to(dt)))
    y2 = F.relu(F.conv2d(x1, p.w2.permute(3, 2, 0, 1).to(dt), p.b2.flatten().to(dt),
                         padding=d, dilation=d))
    y3 = F.conv2d(y2, p.w3.t()[:, :, None, None].to(dt), p.b3.flatten().to(dt))
    res = (F.conv2d(xc, p.wd.t()[:, :, None, None].to(dt), p.bd.flatten().to(dt))
           if p.wd is not None else xc)
    return F.relu(y3 + res)


def check_k3(gen, dtype):
    total = new_total()
    isz = torch.finfo(dtype).bits // 8
    f32 = torch.float32
    for name, h, w, cin, p, ds, per_fwd in K3_CASES:
        cout = 4 * p
        bw = kbottle.BlockWeights(
            w1=randn(gen, cin, p, dtype=f32, scale=cin ** -0.5),
            b1=randn(gen, 1, 1, p, dtype=f32, scale=0.1),
            w2=randn(gen, 3, 3, p, p, dtype=f32, scale=(9 * p) ** -0.5),
            b2=randn(gen, 1, 1, p, dtype=f32, scale=0.1),
            w3=randn(gen, p, cout, dtype=f32, scale=p ** -0.5),
            b3=randn(gen, 1, 1, cout, dtype=f32, scale=0.1),
            wd=randn(gen, cin, cout, dtype=f32, scale=cin ** -0.5) if ds else None,
            bd=randn(gen, 1, 1, cout, dtype=f32, scale=0.1) if ds else None,
        )
        x = randn(gen, N, h, w, cin, dtype=dtype)
        out = kbottle.fused_bottleneck(x, bw, 1)
        ref = kbottle.bottleneck_plain(x, bw, 1)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        del out, ref
        times = (time_ms(lambda: kbottle.fused_bottleneck(x, bw, 1), 2),
                 time_ms(lambda: kbottle.bottleneck_plain(x, bw, 1), 2),
                 time_ms(lambda: _library_bottleneck(x, bw, 1), 2))
        macs = cin * p + 9 * p * p + p * cout + (cin * cout if ds else 0)
        flops = 2.0 * N * h * w * macs
        nbytes = isz * (N * h * w * (cin + cout) + macs) + 4 * (2 * p + cout * (2 if ds else 1))
        record(total, f"K3 {name:14s} N={N} {h}x{w} Cin={cin} P={p} proj={ds}", dtype, err,
               rel, times, flops, nbytes, per_fwd)
        del x, bw
    return total


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel call sites to the plain versions."""
    fa, fb = kattn.flash_attention, kbottle.fused_bottleneck
    kattn.flash_attention = kattn.attention_plain
    kbottle.fused_bottleneck = kbottle.bottleneck_plain
    try:
        yield
    finally:
        kattn.flash_attention, kbottle.fused_bottleneck = fa, fb


def serve_phase():
    cfg = merge_from_file(default_config(),
                          os.path.join(ROOT, "experiments/VidSTG/e2e_STCAT_R101_VidSTG.yaml"))
    cfg = merge_from_list(cfg, [
        "MODEL.WEIGHT", "", "TPU.CONV_IMPL", "pallas", "TPU.CONV_STAGES", "[1,2,3,4]",
        "TPU.FRAME_BUCKETS", "[64]",
    ])
    t0 = time.time()
    pred = GroundingPredictor(cfg, max_batch=2, device="cuda", seed=0)
    print(f"  predictor built in {time.time() - t0:.1f} s: {cfg.MODEL.VISION_BACKBONE.NAME}, "
          f"{cfg.MODEL.TEXT_MODEL.NAME} x{cfg.MODEL.TEXT_MODEL.LAYERS}, d={cfg.MODEL.STCAT.HIDDEN}, "
          f"{cfg.MODEL.STCAT.ENC_LAYERS}/{cfg.MODEL.STCAT.DEC_LAYERS}/{cfg.MODEL.STCAT.DEC_LAYERS} "
          f"layers @{cfg.INPUT.RESOLUTION}, {cfg.TPU.COMPUTE_DTYPE}")
    rng = np.random.RandomState(0)
    requests = [
        (rng.randint(0, 256, (128, 240, 320, 3), dtype=np.uint8), "the man in a red shirt walks left"),
        (rng.randint(0, 256, (128, 240, 320, 3), dtype=np.uint8), "a dog jumps over the fence"),
        (rng.randint(0, 256, (1, 240, 320, 3), dtype=np.uint8), "a child holds a ball"),
    ]

    torch.cuda.reset_peak_memory_stats()
    kattn.LAUNCHES.reset()
    kbottle.LAUNCHES.reset()
    with MicroBatcher(pred, max_wait_ms=50.0) as mb:
        t_submit = time.time()
        futs = [mb.submit(frames, text) for frames, text in requests]
        results, latencies = [], []
        for fut in futs:
            results.append(fut.result(timeout=900))
            latencies.append(time.time() - t_submit)
    launches = {"flash_attention": kattn.LAUNCHES.count,
                "fused_bottleneck": kbottle.LAUNCHES.count}
    print(f"  served {len(results)} requests; latency from submit (s): "
          + ", ".join(f"{x:.3f}" for x in latencies)
          + f"; max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  kernel launches while serving: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main path")

    for (frames, _), res in zip(requests, results):
        t = frames.shape[0]
        if sorted(res["boxes"]) != list(range(t)):
            raise AssertionError("a frame id is missing a box")
        boxes = np.asarray(list(res["boxes"].values()), np.float64)
        if not np.isfinite(boxes).all():
            raise AssertionError("non-finite box")
        s, e = res["span"]
        if not 0 <= s < e <= t:
            raise AssertionError(f"bad span {res['span']} for {t} frames")
        print(f"  request T={t}: span={res['span']} first box={np.round(boxes[0], 1).tolist()}")

    # one served batch again: kernels vs their plain versions
    raw, _, _ = pred.prepare(requests[:2])
    with torch.inference_mode():
        placed = to_device(raw, pred.device)
        out_k = eval_forward(cfg, pred.model, placed)
        with plain_kernels():
            out_p = eval_forward(cfg, pred.model, placed)
        torch.cuda.synchronize()
    for key, tol in SERVE_TOL.items():
        err, rel = rel_err(out_k[key], out_p[key])
        val = err if key == "pred_boxes" else rel
        kind = "abs" if key == "pred_boxes" else "rel"
        print(f"  served forward kernels vs plain: {key} max_abs_err={err:.3e} rel={rel:.3e} "
              f"({kind} tol {tol})")
        if not val <= tol:
            raise AssertionError(f"{key}: kernel forward differs from plain by {val:.3e} > {tol}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    logs = _build.build_all()
    print(f"kernels built in {time.time() - t0:.1f} s")
    for name, log in logs.items():  # ptxas: registers and shared memory per kernel
        for line in log.splitlines():
            if "registers" in line:
                print(f"  {name}: {line.split('info    :')[-1].strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("kernels vs plain versions at the main path's shapes:")
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            k1 = check_k1(gen, dtype)
            k3 = check_k3(gen, dtype)
            for name, tot in (("flash_attention", k1), ("fused_bottleneck", k3)):
                if dtype == torch.bfloat16:
                    totals[name] = tot
                else:
                    totals[name]["max_abs_err"] = max(totals[name]["max_abs_err"],
                                                      tot["max_abs_err"])
    torch.cuda.empty_cache()

    print("serving at full width:")
    launches = serve_phase()

    meta = {
        "flash_attention": ("cuda", "stcat_tpu_torch/csrc/flash_attention.cu",
                            "stcat_tpu/kernels/attention.py:170"),
        "fused_bottleneck": ("cuda", "stcat_tpu_torch/csrc/bottleneck.cu",
                             "stcat_tpu/kernels/conv.py:158"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        t = totals[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
            "library_ms": t["library_ms"],
            "basis": "bf16 times summed over one served forward's calls at the main "
                     "path's shapes; max_abs_err over every shape in bf16 and fp32",
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
