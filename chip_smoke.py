"""Drive the PyTorch port (stcat_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is caught):
  1. device: require CUDA, print the card's name and power limit, the torch
     and CUDA versions, build every kernel (one nvcc per source, in
     parallel) and print ptxas's registers, spills and shared memory per
     kernel entry; count the tensor-core instructions (HMMA, HGMMA) of every
     entry in cuobjdump's SASS of the built libraries, and fail if a bf16
     attention entry meant for the tensor cores has none;
  2. kernels: each hand-written kernel against its plain PyTorch version, in
     bf16 and fp32, with kernel / plain / library times and the card's bound
     for the same work: K1 (attention forward; bf16 on its tensor-core
     kernel, fp32 on its CUDA-core one, Sq < 8 on the row kernel) and K3
     (bottleneck; bf16 on its tensor-core kernel, fp32 on its CUDA-core
     one) at the serving path's shapes (4 lanes x 64 frames, canvas
     448x608, 14x19 feature grid, L = 26), K2 (attention backward, routed as
     K1) at the training path's (one 64-frame clip per microbatch), each
     call site and stage also with its TFLOP/s, share of the bound and ratio
     to the library call; K2 runs twice per call site and must be bitwise
     equal; and the reading behind K3's backward recompute running without
     TF32 (its gradients with cuDNN's TF32 on against off, per stage). The
     times are CUDA-event times over back-to-back calls, host launch cost
     included; K1 and K2 also print each call site's device time (the
     profiler's sum of kernel durations per call) for the kernel and the
     library call, and the kernels the call ran;
  3. serving: the VidSTG R101 recipe at full width (RoBERTa-base, d = 256,
     6/6/6 layers, 448 px) with seeded random weights answers three requests
     through the port's MicroBatcher; K1's and K3's launch counts must rise
     and K2's stay 0; one served batch is re-run with the kernels swapped
     for their plain versions and the outputs compared;
  4. training: the same recipe with STCAT.DROPOUT 0 (so attention takes the
     kernel route), GRAD_ACCUM 2, on two seeded 64-frame clips: first one
     forward+backward with the kernels (twice) and one with their plain
     versions from the initial state (loss, group gradient norms, the
     gradient of every leaf K2 feeds); then 3 steps: losses finite,
     K1/K2/K3 launched (K2 once per K1 launch), the frozen stem and layer1
     unchanged, every trainable group and the EMA moved; then one more step
     under torch.profiler, its device time broken down by kernel (K1, K2,
     K3 forward, the K3 recompute in the backward, the rest) against the
     step's wall time; a kernel whose counter moved but whose device name
     shows no time fails the run.
Every phase prints its seconds. The line before the last is a JSON object
listing every kernel's numbers; the last line is the device record.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
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
from stcat_tpu_torch.data.batching import build_raw_batch  # noqa: E402
from stcat_tpu_torch.data.tokenize import build_tokenizer  # noqa: E402
from stcat_tpu_torch.data.transforms import build_transforms  # noqa: E402
from stcat_tpu_torch.kernels import _build  # noqa: E402
from stcat_tpu_torch.kernels import attention as kattn  # noqa: E402
from stcat_tpu_torch.kernels import bottleneck as kbottle  # noqa: E402
from stcat_tpu_torch.models import build_model  # noqa: E402
from stcat_tpu_torch.serve import GroundingPredictor, MicroBatcher, eval_forward  # noqa: E402
from stcat_tpu_torch.train.optimizer import make_optimizer  # noqa: E402
from stcat_tpu_torch.train.step import (  # noqa: E402
    accumulate_grads, create_train_state, make_train_step,
)

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
# training path: one 64-frame clip per microbatch (GRAD_ACCUM 2 of a 2-clip batch)
TRAIN_FRAMES, TRAIN_STEPS, ACCUM = 64, 3, 2
K2_CASES = [  # name, BH, Sq, Sk, Dk, Dv, launches per training microbatch
    ("encoder spatial", TRAIN_FRAMES * HEADS, S, S, 32, 32, 6),
    ("encoder temporal", HEADS, TRAIN_FRAMES + 1, TRAIN_FRAMES + 1, 32, 32, 6),
    ("spatial-decoder concat cross", TRAIN_FRAMES * HEADS, 1, M, 64, 32, 6),
    ("time-decoder cross", TRAIN_FRAMES * HEADS, 1, M, 32, 32, 6),
]
K1_PER_MICROBATCH = sum(c[-1] for c in K1_CASES)   # 24: K2 runs once per K1 launch
K3_CASES = [  # name, H, W, Cin, P, projection, launches per served forward
    ("layer1 block0", 112, 152, 64, 64, True, 1),
    ("layer1", 112, 152, 256, 64, False, 2),
    ("layer2", 56, 76, 512, 128, False, 3),
    ("layer3", 28, 38, 1024, 256, False, 22),
    ("layer4", 14, 19, 2048, 512, False, 2),
]
K3_PER_MICROBATCH = sum(c[-1] for c in K3_CASES)   # 30 stride-1 blocks
# K1, K3: max |kernel - plain| / max(1, max |plain|); K2: each of dq, dk, dv
# and dbias against its own max |plain|. fp32 differs only in summation
# order over K <= 9*512 terms; bf16 also rounds p (K1), x1/y2 (K3) and the
# outputs at other points than the plain version, ~2 bf16 ulps of the
# largest output
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# served outputs, kernels vs plain versions, both bf16 end to end: boxes are
# sigmoid outputs in [0, 1] (absolute); sted logits scale with the random
# weights (relative to max |plain|). Starting points: test_full_parity.py's
# bf16 envelope (1.5e-2 boxes, 8e-2 sted).
SERVE_TOL = {"pred_boxes": 1.5e-2, "pred_sted": 8e-2}
# one training forward+backward from the initial state, kernels vs plain
# versions, cuDNN deterministic (the kernels' repeat matched bitwise): the
# loss (relative), each optimizer group's gradient norm (relative) and each
# K2-fed leaf's gradient (relative L2 distance). Each limit is about 3x its
# reading on the H100 (bf16: loss 2.0e-4, group norms 1.8e-2, leaves
# 5.1e-2; fp32: 9.3e-8, 5.2e-5, 2.8e-4); the bf16 loss limit also covers
# the 4.2e-4 read at a trained state.
STEP_TOL = {"bfloat16": {"loss": 1e-3, "grad_norm": 5e-2, "leaf": 1.5e-1},
            "float32": {"loss": 3e-7, "grad_norm": 1.5e-4, "leaf": 1e-3}}


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


def device_time(fn, reps: int = 10, windows: int = 3):
    """Device time per call of fn and the names of the kernels it launched:
    their durations summed by torch.profiler over reps calls after one
    warm-up call. A profiler window now and then comes back without device
    events (seen once in some hundred windows on the H100); such a window is
    taken again, up to `windows` times, and the run fails if none records
    any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        if ms > 0:
            return ms, [e.key for e in kernels]
    raise AssertionError(f"the profiler recorded no device time in {windows} windows")


def rel_err(out: torch.Tensor, ref: torch.Tensor):
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(1.0, ref.float().abs().max().item())


def randn(gen, *shape, dtype, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def new_total():
    return dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err",
                          "ops_ms", "bytes_ms"), 0.0)


def record(total, label, dtype, err, rel, times, flops, nbytes, per_fwd):
    """Check the error, print one shape's line and its rates, add it to the
    kernel's total (times weighted by launches per forward, bf16 only)."""
    if not rel <= TOL[dtype]:
        raise AssertionError(f"{label} {dtype}: rel err {rel:.3e} > {TOL[dtype]}")
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    ms, plain_ms, lib_ms = times
    print(f"  {label} {str(dtype):15s}: max_abs_err={err:.3e} rel={rel:.3e} "
          f"(tol {TOL[dtype]}) kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
          f"library={lib_ms:.4f} ms bound={bound:.4f} ms ({by})")
    print(f"    {flops / ms / 1e9:.2f} TFLOP/s, {100 * bound / ms:.1f}% of the bound, "
          f"kernel / library {ms / lib_ms:.3f}")
    if dtype == torch.bfloat16:
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                         ("library_ms", lib_ms), ("ops_ms", t_ops), ("bytes_ms", t_bytes)):
            total[key] += per_fwd * val
    total["max_abs_err"] = max(total["max_abs_err"], err)


def attn_inputs(gen, bh, sq, sk, dk, dv, dtype, grad: bool):
    """Seeded q, k, v, bias and (for the backward) the output gradient g of
    one attention call site, masked as on the main path."""
    q, k = randn(gen, bh, sq, dk, dtype=dtype), randn(gen, bh, sk, dk, dtype=dtype)
    v = randn(gen, bh, sk, dv, dtype=dtype)
    g = randn(gen, bh, sq, dv, dtype=dtype) if grad else None
    bias = torch.zeros(bh, sk, device="cuda")
    bias[:, -L // 2:] = -1e30      # padded text tokens
    bias[: bh // 16, :] = -1e30    # fully masked rows: uniform average
    return q, k, v, bias, g


def device_line(kernel: str, fn, library) -> str:
    """The call site's device times (kernel, library call) and the kernel
    entries the call ran (KERNEL_NAMES fragments of its device kernels)."""
    ms, names = device_time(fn)
    lib_ms = library(lambda f: device_time(f)[0])
    route = "+".join(f for f in KERNEL_NAMES[kernel] if any(f in n for n in names))
    return (f"    device time: kernel {ms:.4f} ms, library {lib_ms:.4f} ms; "
            f"kernels {route or 'none'}")


def check_k1(gen, dtype):
    total = new_total()
    isz = torch.finfo(dtype).bits // 8
    for name, bh, sq, sk, dk, dv, per_fwd in K1_CASES:
        q, k, v, bias, _ = attn_inputs(gen, bh, sq, sk, dk, dv, dtype, grad=False)
        out = kattn.flash_attention(q, k, v, bias)
        ref = kattn.attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        mask = bias[:, None, :].to(dtype)

        def kernel():
            return kattn.flash_attention(q, k, v, bias)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        times = (time_ms(kernel, 10), time_ms(lambda: kattn.attention_plain(q, k, v, bias), 10),
                 time_ms(library, 10))
        flops = 2.0 * bh * sq * sk * (dk + dv)
        nbytes = isz * (bh * sq * dk + bh * sk * dk + bh * sk * dv + bh * sq * dv) + 4 * bh * sk
        record(total, f"K1 {name:30s} BH={bh} Sq={sq} Sk={sk} Dk={dk} Dv={dv}", dtype, err,
               rel, times, flops, nbytes, per_fwd)
        print(device_line("K1 attention forward", kernel, lambda timer: timer(library)))
        del q, k, v, bias, out, ref
    return total


def _sdpa_bwd_ms(q, k, v, mask, g, timer) -> float:
    """Autograd through F.scaled_dot_product_attention: fwd+bwd minus fwd
    by timer (the library yardstick for K2; timed only)."""
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)

    with torch.enable_grad():
        return timer(lambda: fwd().backward(g)) - timer(fwd)


def check_k2(gen, dtype):
    """K2 against attention_bwd_plain: dq, dk, dv and dbias, each output's
    max |diff| relative to that output's own max |plain| (no floor: the
    gradients are far below 1); a second run must match the first bitwise
    (no atomics, on every route)."""
    total = new_total()
    isz = torch.finfo(dtype).bits // 8
    for name, bh, sq, sk, dk, dv, per_mb in K2_CASES:
        q, k, v, bias, g = attn_inputs(gen, bh, sq, sk, dk, dv, dtype, grad=True)
        mask = bias[:, None, :].to(dtype)

        def kernel():
            return kattn.flash_attention_bwd(q, k, v, bias, g)

        with torch.no_grad():
            out = kattn.flash_attention_bwd(q, k, v, bias, g)
            again = kattn.flash_attention_bwd(q, k, v, bias, g)
            ref = kattn.attention_bwd_plain(q, k, v, bias, g)
            torch.cuda.synchronize()
            for key, a, b in zip(("dq", "dk", "dv", "dbias"), out, again):
                if not torch.equal(a, b):
                    raise AssertionError(f"K2 {name} {dtype}: {key} differs between two runs")
            errs = {key: ((a.float() - b.float()).abs().max().item(),
                          b.float().abs().max().item())
                    for key, a, b in zip(("dq", "dk", "dv", "dbias"), out, ref)}
            rels = {key: e / m if m > 0 else (0.0 if e == 0 else float("inf"))
                    for key, (e, m) in errs.items()}
            err, rel = max(e for e, _ in errs.values()), max(rels.values())
            print(f"  K2 {name:30s} {str(dtype):15s}: per output |diff| / max|plain|: "
                  + ", ".join(f"{key} {rels[key]:.3e} (of {m:.3e})"
                              for key, (_, m) in errs.items()))
            del out, again, ref
            times = (time_ms(kernel, 10),
                     time_ms(lambda: kattn.attention_bwd_plain(q, k, v, bias, g), 10))
        times += (_sdpa_bwd_ms(q, k, v, mask, g, lambda f: time_ms(f, 10)),)
        flops = 2.0 * bh * sq * sk * (3 * dk + 3 * dv)
        nbytes = isz * 2 * (bh * sq * dk + bh * sk * dk + bh * sk * dv) + isz * bh * sq * dv \
            + 4 * 2 * bh * sk
        record(total, f"K2 {name:30s} BH={bh} Sq={sq} Sk={sk} Dk={dk} Dv={dv}", dtype, err,
               rel, times, flops, nbytes, per_mb)
        with torch.no_grad():
            line = device_line("K2 attention backward", kernel,
                               lambda timer: _sdpa_bwd_ms(q, k, v, mask, g, timer))
        print(line + "; bitwise equal over two runs")
        del q, k, v, g, bias, mask
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


def k3_weights(gen, cin, p, ds):
    """Seeded folded fp32 weights of a bottleneck block, Cout = 4P."""
    f32, cout = torch.float32, 4 * p
    return kbottle.BlockWeights(
        w1=randn(gen, cin, p, dtype=f32, scale=cin ** -0.5),
        b1=randn(gen, 1, 1, p, dtype=f32, scale=0.1),
        w2=randn(gen, 3, 3, p, p, dtype=f32, scale=(9 * p) ** -0.5),
        b2=randn(gen, 1, 1, p, dtype=f32, scale=0.1),
        w3=randn(gen, p, cout, dtype=f32, scale=p ** -0.5),
        b3=randn(gen, 1, 1, cout, dtype=f32, scale=0.1),
        wd=randn(gen, cin, cout, dtype=f32, scale=cin ** -0.5) if ds else None,
        bd=randn(gen, 1, 1, cout, dtype=f32, scale=0.1) if ds else None,
    )


def check_k3(gen, dtype):
    """K3 against bottleneck_plain at the five stages; bf16 takes the
    tensor-core kernel (timed over 10 calls), fp32 the CUDA-core one (2)."""
    total = new_total()
    reps = 10 if dtype == torch.bfloat16 else 2
    isz = torch.finfo(dtype).bits // 8
    for name, h, w, cin, p, ds, per_fwd in K3_CASES:
        cout = 4 * p
        bw = k3_weights(gen, cin, p, ds)
        x = randn(gen, N, h, w, cin, dtype=dtype)
        out = kbottle.fused_bottleneck(x, bw, 1)
        ref = kbottle.bottleneck_plain(x, bw, 1)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        del out, ref
        times = (time_ms(lambda: kbottle.fused_bottleneck(x, bw, 1), reps),
                 time_ms(lambda: kbottle.bottleneck_plain(x, bw, 1), 2),
                 time_ms(lambda: _library_bottleneck(x, bw, 1), reps))
        macs = cin * p + 9 * p * p + p * cout + (cin * cout if ds else 0)
        flops = 2.0 * N * h * w * macs
        nbytes = isz * (N * h * w * (cin + cout) + macs) + 4 * (2 * p + cout * (2 if ds else 1))
        record(total, f"K3 {name:14s} N={N} {h}x{w} Cin={cin} P={p} proj={ds}", dtype, err, rel,
               times, flops, nbytes, per_fwd)
        ch, cw, stages = kbottle.pick_tile(h, w, cin, p, cout, 1, isz, ds)
        smem = kbottle._smem_bytes(ch, cw, p, 1, isz, cout, ds, stages)
        print(f"    tile {ch}x{cw}" + (f", ring of {stages} slices" if stages else "")
              + f", {smem} B shared memory")
        del x, bw
    return total


def check_recompute_tf32(gen):
    """Why K3's backward recompute runs with cuDNN's TF32 off: at each stage
    (bf16, two frames, deterministic algorithms) the gradients of
    bottleneck_plain with TF32 on against off, ||a - b|| / ||b||. Every
    operand is bf16-valued, so summation order alone would stay near 1e-6."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.allow_tf32
    cudnn.deterministic = True
    try:
        for name, h, w, cin, p, ds, _ in K3_CASES:
            bw = kbottle.BlockWeights(*(None if t is None else t.requires_grad_()
                                        for t in k3_weights(gen, cin, p, ds)))
            x = randn(gen, 2, h, w, cin, dtype=torch.bfloat16).requires_grad_()
            g = randn(gen, 2, h, w, 4 * p, dtype=torch.bfloat16)
            leaves = [x] + [t for t in bw if t is not None]
            grads = []
            for tf32 in (True, False):
                cudnn.allow_tf32 = tf32
                grads.append(torch.autograd.grad(kbottle.bottleneck_plain(x, bw, 1), leaves, g))
            rels = [_rel(a, b) for a, b in zip(*grads)]
            print(f"  K3 recompute {name:14s} TF32 vs fp32 gradients: ||a - b|| / ||b|| "
                  f"x {rels[0]:.2e}, largest {max(rels):.2e}")
    finally:
        cudnn.deterministic, cudnn.allow_tf32 = saved


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel launch for its plain version: the two autograd
    Functions stay in place, their forward runs attention_plain /
    bottleneck_plain and the attention backward attention_bwd_plain (the
    bottleneck's backward is a plain recompute either way)."""
    saved = kattn._launch, kattn._launch_bwd, kbottle._launch
    kattn._launch, kattn._launch_bwd = kattn.attention_plain, kattn.attention_bwd_plain
    kbottle._launch = kbottle.bottleneck_plain
    try:
        yield
    finally:
        kattn._launch, kattn._launch_bwd, kbottle._launch = saved


def recipe_cfg(*opts):
    """The VidSTG R101 recipe at full width, fresh weights, every kernel route on."""
    cfg = merge_from_file(default_config(),
                          os.path.join(ROOT, "experiments/VidSTG/e2e_STCAT_R101_VidSTG.yaml"))
    return merge_from_list(cfg, [
        "MODEL.WEIGHT", "", "TPU.CONV_IMPL", "pallas", "TPU.CONV_STAGES", "[1,2,3,4]",
        "TPU.FRAME_BUCKETS", "[64]", *opts,
    ])


def serve_phase():
    cfg = recipe_cfg()
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
    for counter in (kattn.LAUNCHES, kattn.BWD_LAUNCHES, kbottle.LAUNCHES):
        counter.reset()
    with MicroBatcher(pred, max_wait_ms=50.0) as mb:
        t_submit = time.time()
        futs = [mb.submit(frames, text) for frames, text in requests]
        results, latencies = [], []
        for fut in futs:
            results.append(fut.result(timeout=900))
            latencies.append(time.time() - t_submit)
    launches = {"flash_attention": kattn.LAUNCHES.count,
                "flash_attention_bwd": kattn.BWD_LAUNCHES.count,
                "fused_bottleneck": kbottle.LAUNCHES.count}
    print(f"  served {len(results)} requests; latency from submit (s): "
          + ", ".join(f"{x:.3f}" for x in latencies)
          + f"; max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  kernel launches while serving: {launches}")
    for name in ("flash_attention", "fused_bottleneck"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
    if launches["flash_attention_bwd"] != 0:
        raise AssertionError("serving ran an attention backward (K2)")

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


def _train_batch(cfg):
    """Two seeded 64-frame 320x240 uint8 clips, each with a seeded GT span,
    boxes (normalized cxcywh) and a sentence, through build_raw_batch."""
    rng = np.random.RandomState(1)
    transform = build_transforms(cfg)
    samples = []
    for text in ("the man in a red shirt walks left", "a dog jumps over the fence"):
        s = rng.randint(0, TRAIN_FRAMES // 2)
        e = rng.randint(s + 1, TRAIN_FRAMES)
        actioness = np.zeros(TRAIN_FRAMES, np.float32)
        actioness[s: e + 1] = 1.0
        boxes = np.concatenate([rng.uniform(0.3, 0.7, (e - s + 1, 2)),
                                rng.uniform(0.1, 0.4, (e - s + 1, 2))], -1).astype(np.float32)
        plan, _, text = transform.plan((240, 320), np.zeros((0, 4), np.float32), text)
        samples.append({
            "frames_u8": rng.randint(0, 256, (TRAIN_FRAMES, 240, 320, 3), dtype=np.uint8),
            "plan": plan, "text": text, "actioness": actioness, "boxes_cxcywh": boxes,
        })
    raw, targets, _ = build_raw_batch(samples, TRAIN_FRAMES, build_tokenizer(cfg),
                                      cfg.INPUT.MAX_QUERY_LEN)
    return raw, targets


def _group_grad_norms(opt):
    return {g["name"]: torch.sqrt(sum((p.grad.float() ** 2).sum() for p in g["params"]
                                      if p.grad is not None)).item()
            for g in opt.core.param_groups}


def _k2_leaf(name: str) -> bool:
    """The leaves whose gradient K2 hands back directly: the q/k/v
    projections of the attention calls on the kernel route (the encoder's
    self-attention, the decoders' cross-attention). Not the key projections'
    own biases: softmax ignores a shift shared by every key, so their true
    gradient is 0 and both versions return rounding noise."""
    if re.search(r"\.ca_k\w+_proj\.bias$", name):
        return False
    return ((name.startswith("ground_encoder.") and ".self_attn.in_proj_" in name)
            or ".cross_attn_image.in_proj_" in name or re.search(r"\.ca_\w+_proj\.", name) is not None)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||; 0 where both are 0 (a leaf whose gradient vanishes
    exactly: the first spatial-decoder layer's query-content weight, whose
    input is all zeros at initialisation, as every Linear bias is 0)."""
    diff, ref = (a.float() - b.float()).norm().item(), b.float().norm().item()
    return 0.0 if diff == 0 else diff / ref if ref > 0 else float("inf")


def compare_step(cfg, model, opt, raw, targets) -> None:
    """One forward+backward from the initial state with the kernels, again
    with the kernels, and with their plain versions (same batch and dropout
    seed), cuDNN held to deterministic algorithms. Checks the loss (relative),
    each optimizer group's gradient norm (relative) and each K2-fed leaf's
    gradient (||kernel - plain|| / ||plain||, so a wrong direction shows),
    at the limits of the compute dtype; the kernels' repeat shows that the
    comparison itself is reproducible."""
    tol = STEP_TOL[cfg.TPU.COMPUTE_DTYPE]
    named = dict(model.named_parameters())
    leaves = [n for n in named if _k2_leaf(n) and opt.labels[n] != "frozen"]
    runs = {}
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for label in ("kernels", "kernels again", "plain"):
            with plain_kernels() if label == "plain" else contextlib.nullcontext():
                losses = accumulate_grads(cfg, model, opt, raw, targets,
                                          torch.Generator(device="cuda").manual_seed(1))
            runs[label] = (losses["loss"].item(), _group_grad_norms(opt),
                           {n: named[n].grad.detach().clone() for n in leaves})
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        opt.zero_grad()
    (loss_k, norms_k, leaf_k), (loss_r, _, leaf_r), (loss_p, norms_p, leaf_p) = runs.values()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  {cfg.TPU.COMPUTE_DTYPE} train forward+backward, kernels vs plain: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {rel:.3e}, tol {tol['loss']}); kernels run "
          f"twice: loss rel {abs(loss_k - loss_r) / abs(loss_r):.3e}, K2-fed leaves max rel "
          f"{max(_rel(leaf_k[n], leaf_r[n]) for n in leaves):.3e}")
    if not rel <= tol["loss"]:
        raise AssertionError(f"train loss: kernels differ from plain by {rel:.3e}")
    for g in norms_k:
        r = abs(norms_k[g] - norms_p[g]) / max(norms_p[g], 1e-30)
        print(f"    group {g}: grad norm {norms_k[g]:.6e} vs {norms_p[g]:.6e} (rel {r:.3e}, "
              f"tol {tol['grad_norm']})")
        if not r <= tol["grad_norm"]:
            raise AssertionError(f"group {g} grad norm: kernels differ from plain by {r:.3e}")
    leaf_rel = sorted(((_rel(leaf_k[n], leaf_p[n]), n) for n in leaves), reverse=True)
    print(f"    {len(leaves)} K2-fed leaves, ||kernel - plain|| / ||plain||: median "
          f"{leaf_rel[len(leaf_rel) // 2][0]:.3e}, largest "
          + ", ".join(f"{n} {r:.3e}" for r, n in leaf_rel[:3]) + f" (tol {tol['leaf']})")
    if not leaf_rel[0][0] <= tol["leaf"]:
        raise AssertionError(f"{leaf_rel[0][1]}: gradient differs from plain by {leaf_rel[0][0]:.3e}")


# device-kernel name fragments of each hand-written kernel
KERNEL_NAMES = {"K1 attention forward": ("flash_fwd_mma", "flash_fwd_tiled", "flash_fwd_rows"),
                "K2 attention backward": ("bwd_query_mma", "bwd_key_mma", "bwd_query_pass",
                                          "bwd_key_pass", "bwd_rows"),
                "K3 bottleneck forward": ("bottleneck_tc", "bottleneck_fwd")}
# the launch counter behind each of them
KERNEL_COUNTERS = {"K1 attention forward": kattn.LAUNCHES,
                   "K2 attention backward": kattn.BWD_LAUNCHES,
                   "K3 bottleneck forward": kbottle.LAUNCHES}
# the bf16 entries that must run on the tensor cores
TENSOR_CORE_ENTRIES = ("flash_fwd_mma", "bwd_query_mma", "bwd_key_mma", "bottleneck_tc")


def entry_label(mangled: str) -> str:
    """A kernel entry's readable name, e.g. flash_fwd_rows<bf16,1>, from its
    mangled name."""
    frag = next((f for frags in KERNEL_NAMES.values() for f in frags if f in mangled), None)
    if frag is None:
        return mangled
    rest = mangled[mangled.index(frag) + len(frag):]
    region = rest[:rest.find("Ev")] if rest.startswith("I") else ""
    args = (["bf16"] if "__nv_bfloat16" in region else ["fp32"] if region.startswith("If")
            else []) + re.findall(r"Li(\d+)E", region)
    return frag + (f"<{','.join(args)}>" if args else "")


def tensor_core_counts() -> dict:
    """HMMA + HGMMA instructions per kernel entry in the SASS of every built
    library (cuobjdump beside nvcc)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    counts = {}
    for name in _build.SOURCES:
        sass = subprocess.run([cuobjdump, "--dump-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        entry = None
        for line in sass.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                entry = entry_label(found.group(1))
                counts[entry] = 0
            elif entry and re.search(r"\b(HMMA|HGMMA)\b", line):
                counts[entry] += 1
    return counts


def profile_step(step, state, raw, targets, gen) -> None:
    """One train step under torch.profiler: device time per hand-written
    kernel, the K3 recompute (device time under the bottleneck Function's
    backward node: bottleneck_plain forward and backward, cuDNN), the rest,
    and the device's busy share of the step's wall time (one stream, so the
    kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = {name: c.count for name, c in KERNEL_COUNTERS.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        step(state, raw, targets, gen)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    launched = {name: c.count - before[name] for name, c in KERNEL_COUNTERS.items()}
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  profiled step: wall {wall_ms:.1f} ms (profiler on), device kernels {device_ms:.1f} ms "
          f"in {sum(e.count for e in kernels)} launches")
    if device_ms <= 0:
        print("  the profiler recorded no device time: breakdown not measured")
        return
    shares = {name: sum(e.self_device_time_total for e in kernels
                        if any(f in e.key for f in frags)) / 1e3
              for name, frags in KERNEL_NAMES.items()}
    for name, n in launched.items():
        if n > 0 and shares[name] <= 0:
            raise AssertionError(f"{name} launched {n} times in the traced step but no device "
                                 f"kernel named {KERNEL_NAMES[name]} took any time")
    shares["K3 recompute (plain fp32, autograd)"] = max(
        (e.device_time_total for e in events if "FusedBottleneckBackward" in e.key
         and e.device_type != torch.autograd.DeviceType.CUDA), default=0) / 1e3
    shares["everything else"] = device_ms - sum(shares.values())
    for name, ms in shares.items():
        print(f"    {name:32s} {ms:9.1f} ms  {100 * ms / device_ms:5.1f}% of device time")
    print(f"    device busy {100 * device_ms / wall_ms:.1f}% of the step's wall time")
    print("  top device kernels (self time):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.1f} ms x{e.count:5d}  {e.key[:100]}")


def train_phase():
    cfg = recipe_cfg("MODEL.STCAT.DROPOUT", "0.0", "TPU.GRAD_ACCUM", str(ACCUM),
                     "SOLVER.WARMUP_PROP", "0.0")
    t0 = time.time()
    model = build_model(cfg, "cuda", seed=0)
    opt = make_optimizer(cfg, model, num_training_steps=1000)
    state = create_train_state(cfg, model, opt)
    step = make_train_step(cfg, model, opt)
    raw, targets = _train_batch(cfg)
    raw, targets = to_device(raw, model.input_proj.weight.device), \
        to_device(targets, model.input_proj.weight.device)
    named = dict(model.named_parameters())
    groups = {g["name"]: [n for n, lbl in opt.labels.items() if lbl == g["name"]]
              for g in opt.core.param_groups}
    frozen = [n for n, lbl in opt.labels.items() if lbl == "frozen"]
    print(f"  model, optimizer and batch built in {time.time() - t0:.1f} s: "
          f"{sum(p.numel() for p in named.values()) / 1e6:.1f} M parameters; groups "
          + ", ".join(f"{g} {len(ns)}" for g, ns in groups.items()) + f", frozen {len(frozen)}; "
          f"batch 2 clips x {TRAIN_FRAMES} frames on {raw.out_canvas}, GRAD_ACCUM {ACCUM}, "
          f"spans {targets.temp_bound.tolist()}")
    compare_step(cfg, model, opt, raw, targets)
    # the same comparison in fp32, where the two routes differ only in
    # summation order: a fresh model from the same seed, freed afterwards
    cfg32 = merge_from_list(cfg, ["TPU.COMPUTE_DTYPE", "float32"])
    model32 = build_model(cfg32, "cuda", seed=0)
    compare_step(cfg32, model32, make_optimizer(cfg32, model32, num_training_steps=1000),
                 raw, targets)
    del model32
    torch.cuda.empty_cache()

    before = {n: p.detach().clone() for n, p in named.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)

    torch.cuda.reset_peak_memory_stats()
    for counter in (kattn.LAUNCHES, kattn.BWD_LAUNCHES, kbottle.LAUNCHES):
        counter.reset()
    step_s = []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.time()
        metrics = step(state, raw, targets, gen)
        torch.cuda.synchronize()
        step_s.append(time.time() - t)
        mem = torch.cuda.max_memory_allocated() / 2**30
        print(f"  step {i}: loss={metrics['loss']:.5f} (bbox {metrics['loss_bbox']:.4f}, "
              f"giou {metrics['loss_giou']:.4f}, sted {metrics['loss_sted']:.4f}) "
              f"time={step_s[-1]:.3f} s "
              f"max_memory_allocated={mem:.2f} GiB")
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"step {i}: non-finite losses {bad}")
    launches = {"flash_attention": kattn.LAUNCHES.count,
                "flash_attention_bwd": kattn.BWD_LAUNCHES.count,
                "fused_bottleneck": kbottle.LAUNCHES.count}
    microbatches = TRAIN_STEPS * ACCUM
    print(f"  kernel launches while training ({microbatches} microbatches): {launches}")
    want = {"flash_attention": K1_PER_MICROBATCH * microbatches,
            "flash_attention_bwd": K1_PER_MICROBATCH * microbatches,
            "fused_bottleneck": K3_PER_MICROBATCH * microbatches}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want} (K2 once per K1 launch)")
    print(f"  step time from the second step on: "
          + ", ".join(f"{x:.3f}" for x in step_s[1:]) + " s")

    for n in frozen:
        if not torch.equal(named[n].detach(), before[n]):
            raise AssertionError(f"frozen parameter {n} changed")
    for g, names in groups.items():
        moved = sum((named[n].detach() - before[n]).abs().sum().item() for n in names)
        ema_moved = sum((state.ema[n] - before[n]).abs().sum().item() for n in names)
        gap_before = moved
        gap_after = sum((named[n].detach() - state.ema[n]).abs().sum().item() for n in names)
        print(f"  group {g}: sum |param - initial| = {moved:.4e}, sum |EMA - initial| = "
              f"{ema_moved:.4e}, sum |param - EMA| = {gap_after:.4e}")
        if not (moved > 0 and 0 < ema_moved and gap_after < gap_before):
            raise AssertionError(f"group {g}: params or EMA did not move as expected")
    print(f"  frozen stem + layer1: {len(frozen)} parameters bitwise unchanged")
    del before

    profile_step(step, state, raw, targets, gen)
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
    for name, log in logs.items():  # ptxas: registers, spills and shared memory per kernel
        entry = name
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = entry_label(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print(f"  {name} {entry}: {line.split('info    :')[-1].strip()}")
    counts = tensor_core_counts()
    print("tensor-core instructions (HMMA/HGMMA) per entry in the built SASS: "
          + ", ".join(f"{e} {n}" for e, n in counts.items()))
    for frag in TENSOR_CORE_ENTRIES:
        entries = {e: n for e, n in counts.items() if e.startswith(frag)}
        if not entries or min(entries.values()) == 0:
            raise AssertionError(f"{frag}: no tensor-core instructions in its SASS ({entries})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("kernels vs plain versions at the main path's shapes:")
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {}
    for dtype in (torch.bfloat16, torch.float32):
        with torch.inference_mode():
            found = {"flash_attention": check_k1(gen, dtype),
                     "fused_bottleneck": check_k3(gen, dtype)}
        found["flash_attention_bwd"] = check_k2(gen, dtype)
        if dtype == torch.bfloat16:
            check_recompute_tf32(gen)
        for name, tot in found.items():
            if dtype == torch.bfloat16:
                totals[name] = tot
            else:
                totals[name]["max_abs_err"] = max(totals[name]["max_abs_err"],
                                                  tot["max_abs_err"])
    torch.cuda.empty_cache()
    print(f"kernel phase took {time.time() - t0:.1f} s")

    print("serving at full width:")
    t0 = time.time()
    served = serve_phase()
    torch.cuda.empty_cache()
    print(f"serving phase took {time.time() - t0:.1f} s")

    print("training at full width:")
    t0 = time.time()
    trained = train_phase()
    print(f"training phase took {time.time() - t0:.1f} s")

    per_fwd = ("bf16 CUDA-event times summed over one served forward's calls at the serving "
               "path's shapes (4 lanes x 64 frames)")
    meta = {
        "flash_attention": ("cuda", "stcat_tpu_torch/csrc/flash_attention.cu",
                            "stcat_tpu/kernels/attention.py:170", per_fwd),
        "flash_attention_bwd": ("cuda", "stcat_tpu_torch/csrc/flash_attention_bwd.cu",
                                "stcat_tpu/kernels/attention.py:251",
                                "bf16 CUDA-event times summed over one training microbatch's "
                                "calls (one 64-frame clip)"),
        "fused_bottleneck": ("cuda", "stcat_tpu_torch/csrc/bottleneck.cu",
                             "stcat_tpu/kernels/conv.py:158", per_fwd),
    }
    kernels = []
    for name, (route, source, replaces, basis) in meta.items():
        t = totals[name]
        by_path = {"serving": served[name], "training": trained[name]}
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
            "library_ms": t["library_ms"],
            "basis": basis + "; max_abs_err over every shape in bf16 and fp32",
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
