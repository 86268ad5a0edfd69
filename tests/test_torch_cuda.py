"""Card-only tests of the port: the CUDA kernels (K1 attention forward, K2
attention backward, K3 bottleneck) against their plain versions, the two
autograd Functions' gradients against autograd through the plain versions,
and the tiny model's forward and training gradients on the card against the
same on the CPU. Every test here is marked ``cuda`` and skips without a card.

This file imports torch and numpy only, so it also runs where JAX is not
installed (the machine with the card):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerances are relative to max |plain|: fp32 differs in summation order only
(1e-4); bf16 also rounds p (attention) and x1/y2 (bottleneck) at other points
than the plain version (2e-2, about two bf16 ulps). The bottleneck's and the
attention kernels' bf16 inputs take their tensor-core kernels and fp32
inputs their CUDA-core kernels; attention with Sq < 8 takes the row kernels
in either dtype.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import torch_grad_check as gc
from chip_smoke import plain_kernels
from stcat_tpu_torch.kernels import attention as pka
from stcat_tpu_torch.kernels import bottleneck as pkb
from torch_grad_check import tiny_cfg

TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    return err / max(1.0, ref.float().abs().max().item())


# shapes of the attention kernels' card tests beyond each test's own: a
# partial 64-query tile (Sq 8, 15, 65), Sk no multiple of 64 (17, 293), Sk
# streamed past one tile load (896, 2048), odd head widths on every route,
# Dk = 2 Dv on the tensor cores, and a BH of several waves of blocks
ATTN_EDGE_CASES = [
    (5, 8, 17, 32, 32), (5, 15, 293, 32, 32), (4, 65, 65, 32, 32), (2, 100, 2048, 32, 32),
    (2, 1, 2048, 32, 32), (3, 64, 40, 100, 70), (6, 65, 293, 64, 32), (600, 8, 40, 32, 32),
    (8, 3, 896, 64, 64),
]


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("bh,sq,sk,dk,dv", [
    (4, 37, 53, 32, 32), (8, 1, 223, 32, 32), (2, 130, 300, 32, 32), (8, 1, 53, 64, 32),
    (8, 8, 896, 32, 32), (3, 5, 40, 100, 70), (64, 293, 293, 32, 32),
] + ATTN_EDGE_CASES)
def test_flash_attention_kernel_matches_plain(dev, dtype, tol, bh, sq, sk, dk, dv):
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev, dtype)
               for s in ((bh, sq, dk), (bh, sk, dk), (bh, sk, dv)))
    bias = torch.zeros(bh, sk, device=dev)
    bias[:, sk - 7:] = -1e30
    bias[1, :] = -1e30  # fully masked row: uniform average over the real keys
    before = pka.LAUNCHES.count
    out = pka.flash_attention(q, k, v, bias)
    assert pka.LAUNCHES.count == before + 1
    ref = pka.attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert out.shape == (bh, sq, dv) and out.dtype == dtype
    assert _rel_err(out, ref) <= tol


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("n,h,w,cin,p,ds,dil", [
    (2, 8, 8, 16, 8, True, 1),
    (1, 8, 6, 32, 8, False, 1),
    (1, 10, 10, 32, 8, False, 2),
    (1, 10, 152, 64, 64, True, 1),    # several tiles, the last one partial
    (1, 9, 152, 256, 64, False, 2),   # dilated, several tiles
])
def test_fused_bottleneck_kernel_matches_plain(dev, dtype, tol, n, h, w, cin, p, ds, dil):
    rng = np.random.RandomState(1)
    cout = 4 * p

    def mk(*s, scale):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32)).to(dev)

    bw = pkb.BlockWeights(
        w1=mk(cin, p, scale=cin ** -0.5), b1=mk(1, 1, p, scale=0.1),
        w2=mk(3, 3, p, p, scale=(9 * p) ** -0.5), b2=mk(1, 1, p, scale=0.1),
        w3=mk(p, cout, scale=p ** -0.5), b3=mk(1, 1, cout, scale=0.1),
        wd=mk(cin, cout, scale=cin ** -0.5) if ds else None,
        bd=mk(1, 1, cout, scale=0.1) if ds else None,
    )
    x = mk(n, h, w, cin, scale=1.0).to(dtype)
    before = pkb.LAUNCHES.count
    out = pkb.fused_bottleneck(x, bw, dil)
    assert pkb.LAUNCHES.count == before + 1
    with torch.no_grad():  # weights packed once: the same launch, the same bits
        assert torch.equal(pkb.fused_bottleneck(x, pkb.pack(bw, dtype), dil), out)
    assert pkb.LAUNCHES.count == before + 2
    ref = pkb.bottleneck_plain(x, bw, dil)
    torch.cuda.synchronize()
    assert out.shape == (n, h, w, cout) and out.dtype == dtype
    assert _rel_err(out, ref) <= tol


# the main path's stride-1 blocks (R101 at 448x608: layer1's first block with
# its projection, then layers 1-4), two frames
STAGES = [  # h, w, cin, p, projection
    (112, 152, 64, 64, True),
    (112, 152, 256, 64, False),
    (56, 76, 512, 128, False),
    (28, 38, 1024, 256, False),
    (14, 19, 2048, 512, False),
]


def _block(dev, rng, cin, p, ds, grad=False):
    """Seeded folded weights at He-like scales (fp32, as the backbone folds them)."""
    cout = 4 * p
    scales = {"w1": cin ** -0.5, "w2": (9 * p) ** -0.5, "w3": p ** -0.5, "wd": cin ** -0.5}
    shapes = {"w1": (cin, p), "b1": (1, 1, p), "w2": (3, 3, p, p), "b2": (1, 1, p),
              "w3": (p, cout), "b3": (1, 1, cout), "wd": (cin, cout), "bd": (1, 1, cout)}
    ts = {k: torch.from_numpy((rng.randn(*s) * scales.get(k, 0.1)).astype(np.float32)).to(dev)
          for k, s in shapes.items() if ds or k not in ("wd", "bd")}
    return pkb.BlockWeights(**{k: ts[k].requires_grad_(grad) if k in ts else None
                               for k in pkb.BlockWeights._fields})


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("h,w,cin,p,ds", STAGES)
def test_fused_bottleneck_kernel_matches_plain_at_main_path_stages(dev, dtype, tol, h, w, cin,
                                                                   p, ds):
    rng = np.random.RandomState(5)
    bw = _block(dev, rng, cin, p, ds)
    x = torch.from_numpy(rng.randn(2, h, w, cin).astype(np.float32)).to(dev, dtype)
    before = pkb.LAUNCHES.count
    out = pkb.fused_bottleneck(x, bw, 1)
    assert pkb.LAUNCHES.count == before + 1
    ref = pkb.bottleneck_plain(x, bw, 1)
    torch.cuda.synchronize()
    assert out.shape == (2, h, w, 4 * p) and out.dtype == dtype
    assert _rel_err(out, ref) <= tol


# R101-DC5's layer4 at 448x608 (28 x 38): layer4.0, a projection at dilation
# 1, and layer4.1 (and .2) at dilation 2
DC5_LAYER4 = [  # h, w, cin, p, projection, dilation
    (28, 38, 1024, 512, True, 1),
    (28, 38, 2048, 512, False, 2),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_weights_on_the_card_are_the_kernels_operands_only(dev, dtype):
    """On the card pack keeps no cast copy of the weights: unpack gives them
    back from the operands, bit for bit; a launch checks x against the shape
    and dtype pack kept."""
    rng = np.random.RandomState(8)
    bw = _block(dev, rng, 64, 64, True)
    packed = pkb.pack(bw, dtype)
    assert packed.weights is None and all(t is None or t.is_cuda for t in packed.operands)
    cpu = pkb.pack(pkb.BlockWeights(*[None if t is None else t.cpu() for t in bw]), dtype)
    for name, got, want in zip(pkb.BlockWeights._fields, pkb.unpack(packed), cpu.weights):
        assert (got is None) == (want is None), name
        assert got is None or torch.equal(got.cpu(), want), name
    x = torch.from_numpy(rng.randn(1, 6, 5, 64).astype(np.float32)).to(dev, dtype)
    with torch.no_grad():
        with pytest.raises(ValueError, match="the weights take 64"):
            pkb.fused_bottleneck(x[..., :32].contiguous(), packed, 1)
        other = torch.bfloat16 if dtype == torch.float32 else torch.float32
        with pytest.raises(ValueError, match="packed for"):
            pkb.fused_bottleneck(x.to(other), packed, 1)
        out = pkb.fused_bottleneck(x, packed, 1)
    torch.cuda.synchronize()
    assert _rel_err(out, pkb.bottleneck_plain(x, bw, 1)) <= dict(TOLS)[dtype]


@pytest.mark.parametrize("h,w,cin,p,ds,dil", DC5_LAYER4, ids=["layer4.0", "layer4.1"])
def test_fused_bottleneck_kernel_matches_plain_at_dc5_layer4(dev, h, w, cin, p, ds, dil):
    """bf16, two frames, packed weights as the folded backbone hands them
    over: K3 against bottleneck_plain; one launch, counted in k3.dilated at
    dilation 2 only."""
    rng = np.random.RandomState(6)
    bw = _block(dev, rng, cin, p, ds)
    x = torch.from_numpy(rng.randn(2, h, w, cin).astype(np.float32)).to(dev, torch.bfloat16)
    launches, dilated = pkb.LAUNCHES.count, pkb.DILATED.count
    with torch.no_grad():
        out = pkb.fused_bottleneck(x, pkb.pack(bw, torch.bfloat16), dil)
    assert pkb.LAUNCHES.count == launches + 1
    assert pkb.DILATED.count == dilated + (dil == 2)
    ref = pkb.bottleneck_plain(x, bw, dil)
    torch.cuda.synchronize()
    assert out.shape == (2, h, w, 4 * p) and out.dtype == torch.bfloat16
    assert _rel_err(out, ref) <= 2e-2


@pytest.mark.parametrize("dc5,launches,dilated", [(False, 30, 0), (True, 31, 2)],
                         ids=["r101", "dc5"])
def test_a_bf16_body_forward_counts_its_k3_launches(dev, dc5, launches, dilated):
    """An R101 body's bf16 forward without gradient launches K3 once per
    stride-1 block: 30, none dilated; with DC5 layer4.0 joins them (31) and
    layer4.1-2 are the two at dilation 2."""
    from stcat_tpu_torch.models.resnet import build_resnet

    torch.manual_seed(0)
    body = build_resnet("resnet101", dc5, dtype=torch.bfloat16).to(dev).eval()
    x = torch.randn(2, 224, 320, 3, device=dev)
    before = pkb.LAUNCHES.count, pkb.DILATED.count
    with torch.inference_mode():
        out = body(x)
    torch.cuda.synchronize()
    assert (pkb.LAUNCHES.count - before[0], pkb.DILATED.count - before[1]) == (launches, dilated)
    assert tuple(out.shape) == (2, 224 // body.stride, 320 // body.stride, 2048)


@pytest.mark.parametrize("dtype,tol", TOLS)
def test_fused_bottleneck_kernel_ragged_tiles(dev, dtype, tol, monkeypatch):
    """A frame whose tiles end ragged in both directions and whose pixel
    count per tile is no multiple of 64 (a partial warpgroup tile), dilation 2.
    pick_tile takes the whole height of this frame, so the plan is given:
    12 x 10 tiles on a 4-slice ring (bf16), which fit shared memory."""
    rng = np.random.RandomState(6)
    h, w, cin, p = 31, 57, 256, 64
    bw = _block(dev, rng, cin, p, False)
    itemsize = torch.finfo(dtype).bits // 8
    ch, cw, stages = 12, 10, (4 if itemsize == 2 else 0)
    assert h % ch and w % cw and (ch * cw) % 64
    assert pkb._smem_bytes(ch, cw, p, 2, itemsize, 4 * p, False, stages) <= pkb.SMEM_LIMIT
    monkeypatch.setattr(pkb, "pick_tile", lambda *args: (ch, cw, stages))
    x = torch.from_numpy(rng.randn(3, h, w, cin).astype(np.float32)).to(dev, dtype)
    out = pkb.fused_bottleneck(x, bw, 2)
    ref = pkb.bottleneck_plain(x, bw, 2)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= tol


@pytest.mark.parametrize("stages", pkb.RINGS)
def test_fused_bottleneck_kernel_wraps_the_ring_many_times(dev, stages, monkeypatch):
    """bf16 layer4 (P = 512: the 3x3's K = 9 x 512 is 144 slices) on every
    ring depth the kernel takes, each with its best tile: the producers and
    the consumers go round the ring dozens of times per GEMM, and the result
    matches bottleneck_plain."""
    rng = np.random.RandomState(7)
    h, w, cin, p = 14, 19, 2048, 512
    bw = _block(dev, rng, cin, p, False)
    _, (ch, cw) = pkb._best_tile(h, w, cin, p, 4 * p, 1, 2, False, stages)
    assert 9 * p // pkb.BK >= 20 * stages
    monkeypatch.setattr(pkb, "pick_tile", lambda *args: (ch, cw, stages))
    x = torch.from_numpy(rng.randn(1, h, w, cin).astype(np.float32)).to(dev, torch.bfloat16)
    with torch.no_grad():
        out = pkb.fused_bottleneck(x, pkb.pack(bw, torch.bfloat16), 1)
    ref = pkb.bottleneck_plain(x, bw, 1)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= 2e-2


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("h,w,cin,p,ds", STAGES)
def test_bottleneck_smem_bytes_matches_the_kernel(dev, itemsize, h, w, cin, p, ds):
    from stcat_tpu_torch.kernels import _build

    fn = _build.load("bottleneck").bottleneck_smem_bytes  # declared as the library loads
    ch, cw, stages = pkb.pick_tile(h, w, cin, p, 4 * p, 1, itemsize, ds)
    rings = pkb.RINGS if itemsize == 2 else (0,)
    for tile, st in [((ch, cw), stages)] + [(t, r) for t in ((1, 1), (ch, 1)) for r in rings]:
        assert fn(*tile, p, 1, itemsize, 4 * p, int(ds), st) == \
            pkb._smem_bytes(*tile, p, 1, itemsize, 4 * p, ds, st)


@pytest.mark.parametrize("h,w,cin,p,ds", STAGES)
def test_bottleneck_recompute_ignores_the_callers_tf32_flag(dev, h, w, cin, p, ds):
    """bf16: every gradient of fused_bottleneck with cuDNN's TF32 switched on
    by the caller, against autograd through bottleneck_plain with it off.
    The recompute turns TF32 off itself: TF32 convolutions of these
    bf16-valued operands moved the gradients by 1e-3 to 1.6e-2 (relative L2),
    not by summation order alone. Both sides run deterministic cuDNN, so
    ||a - b|| / ||b|| <= 1e-5 leaves room for summation order only."""
    rng = np.random.RandomState(7)
    bw = _block(dev, rng, cin, p, ds, grad=True)
    x = torch.from_numpy(rng.randn(2, h, w, cin).astype(np.float32)).to(dev, torch.bfloat16)
    g = torch.from_numpy(rng.randn(2, h, w, 4 * p).astype(np.float32)).to(dev, torch.bfloat16)
    leaves = [x.requires_grad_()] + [t for t in bw if t is not None]
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.allow_tf32
    cudnn.deterministic, cudnn.allow_tf32 = True, True
    try:
        got = torch.autograd.grad(pkb.fused_bottleneck(x, bw, 1), leaves, g)
        assert cudnn.allow_tf32
        cudnn.allow_tf32 = False
        want = torch.autograd.grad(pkb.bottleneck_plain(x, bw, 1), leaves, g)
        torch.cuda.synchronize()
    finally:
        cudnn.deterministic, cudnn.allow_tf32 = saved
    names = ["x"] + [k for k, t in zip(pkb.BlockWeights._fields, bw) if t is not None]
    for name, a, b in zip(names, got, want):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel <= 1e-5, (name, rel)


def _attn_inputs(dev, dtype, bh, sq, sk, dk, dv, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev, dtype)
                  for s in ((bh, sq, dk), (bh, sk, dk), (bh, sk, dv), (bh, sq, dv)))
    bias = torch.zeros(bh, sk, device=dev)
    bias[:, sk - 7:] = -1e30
    bias[1, :] = -1e30  # fully masked row: uniform weights over the real keys
    return q, k, v, bias, g


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("bh,sq,sk,dk,dv", [
    (4, 37, 53, 32, 32),     # two-pass, ragged Sq and Sk
    (8, 1, 223, 32, 32),     # row kernel
    (8, 1, 53, 64, 32),      # row kernel, Dk = 2 Dv (concat cross-attention)
    (3, 7, 40, 100, 70),     # row kernel at its largest Sq, odd widths
    (3, 9, 40, 70, 100),     # two-pass, Dv > Dk
    (2, 40, 17, 128, 128),   # widest heads, fewer keys than a tile
    (8, 65, 65, 32, 32),     # encoder temporal
    (64, 293, 293, 32, 32),  # encoder spatial
] + ATTN_EDGE_CASES)
def test_flash_attention_bwd_kernel_matches_plain(dev, dtype, tol, bh, sq, sk, dk, dv):
    q, k, v, bias, g = _attn_inputs(dev, dtype, bh, sq, sk, dk, dv)
    before = pka.BWD_LAUNCHES.count
    out = pka.flash_attention_bwd(q, k, v, bias, g)
    assert pka.BWD_LAUNCHES.count == before + 1
    ref = pka.attention_bwd_plain(q, k, v, bias, g)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a.float()).all(), name
        assert _rel_err(a, b) <= tol, name


@pytest.mark.parametrize("dtype,tol", TOLS)
def test_flash_attention_function_grads_on_card(dev, dtype, tol):
    """autograd through the Function (K1 forward, K2 backward) against
    autograd through attention_plain."""
    q, k, v, bias, g = _attn_inputs(dev, dtype, 6, 37, 53, 64, 32, seed=1)
    grads = []
    for fn in (pka.flash_attention, pka.attention_plain):
        ts = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        fn(*ts).backward(g)
        grads.append([t.grad for t in ts])
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), *grads):
        assert _rel_err(a, b) <= tol, name


@pytest.mark.parametrize("dtype,tol", TOLS)
def test_fused_bottleneck_function_grads_on_card(dev, dtype, tol):
    """The Function's backward (a bottleneck_plain recompute under autograd)
    after a K3 forward, against autograd through bottleneck_plain."""
    rng = np.random.RandomState(3)
    n, h, w, cin, p = 2, 10, 12, 64, 16
    shapes = {"w1": (cin, p), "b1": (1, 1, p), "w2": (3, 3, p, p), "b2": (1, 1, p),
              "w3": (p, 4 * p), "b3": (1, 1, 4 * p), "wd": (cin, 4 * p), "bd": (1, 1, 4 * p)}
    arrays = {k: (rng.randn(*s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    x0 = rng.randn(n, h, w, cin).astype(np.float32)
    g = torch.from_numpy(rng.randn(n, h, w, 4 * p).astype(np.float32)).to(dev, dtype)
    grads = []
    for fn in (pkb.fused_bottleneck, pkb.bottleneck_plain):
        x = torch.from_numpy(x0).to(dev, dtype).requires_grad_()
        bw = pkb.BlockWeights(**{k: torch.from_numpy(a).to(dev).requires_grad_()
                                 for k, a in arrays.items()})
        fn(x, bw, 1).backward(g)
        grads.append([x.grad] + [t.grad for t in bw])
    torch.cuda.synchronize()
    for name, a, b in zip(("x",) + pkb.BlockWeights._fields, *grads):
        assert _rel_err(a, b) <= tol, name


# one shape per K2 route: (dtype, bh, sq, sk, dk, dv)
K2_ROUTES = [
    (torch.bfloat16, 64, 293, 293, 32, 32),  # tensor-core passes
    (torch.float32, 8, 65, 65, 32, 32),      # CUDA-core passes
    (torch.bfloat16, 64, 1, 292, 64, 32),    # row kernel
    (torch.float32, 8, 3, 300, 100, 70),     # row kernel, fp32, odd widths
    (torch.bfloat16, 4, 40, 896, 100, 70),   # tensor-core passes, element-wise loads
]


@pytest.mark.parametrize("dtype,bh,sq,sk,dk,dv", K2_ROUTES)
def test_flash_attention_bwd_is_deterministic(dev, dtype, bh, sq, sk, dk, dv):
    """No atomics: two runs of K2 on the same inputs are bitwise equal."""
    q, k, v, bias, g = _attn_inputs(dev, dtype, bh, sq, sk, dk, dv, seed=2)
    first = pka.flash_attention_bwd(q, k, v, bias, g)
    second = pka.flash_attention_bwd(q, k, v, bias, g)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("sq", [1, 37])
def test_flash_attention_kernels_take_offset_views(dev, dtype, tol, sq):
    """A contiguous view that starts one element past an aligned address (not
    16-byte aligned) takes the same kernels, through the element-by-element
    loads, and gives the aligned tensors' results."""
    q, k, v, bias, g = _attn_inputs(dev, dtype, 4, sq, 53, 32, 32, seed=3)
    shifted = []
    for t in (q, k, v, g):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        buf[1:] = t.flatten()
        shifted.append(buf[1:].view(t.shape))
    sq_, sk_, sv_, sg_ = shifted
    assert sq_.is_contiguous() and sq_.data_ptr() % 16 != 0
    assert not pka.vector_loads((sq_, sk_, sv_, sg_), (32, 32), sq_.element_size())
    torch.testing.assert_close(pka.flash_attention(sq_, sk_, sv_, bias),
                               pka.flash_attention(q, k, v, bias), rtol=0, atol=0)
    for a, b in zip(pka.flash_attention_bwd(sq_, sk_, sv_, bias, sg_),
                    pka.flash_attention_bwd(q, k, v, bias, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flash_attention_bwd_refuses_bad_inputs(dev):
    q, k, v, bias, g = _attn_inputs(dev, torch.float32, 2, 9, 11, 16, 8)
    with pytest.raises(ValueError, match="g must be"):
        pka.flash_attention_bwd(q, k, v, bias, g.to(torch.bfloat16))
    with pytest.raises(ValueError, match="g must be"):
        pka.flash_attention_bwd(q, k, v, bias, g[:, :5])
    with pytest.raises(ValueError, match="fp32 or bf16"):
        pka.flash_attention_bwd(q.half(), k.half(), v.half(), bias, g.half())
    with pytest.raises(ValueError, match="shape mismatch"):
        pka.flash_attention_bwd(q, k[:, :5], v, bias, g)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(2, 3, 16, device=dev)
    bias = torch.zeros(2, 5, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        pka.flash_attention(q, torch.zeros(2, 16, 5, device=dev).transpose(1, 2),
                            torch.zeros(2, 5, 8, device=dev), bias)
    with pytest.raises(ValueError, match="head dims"):
        pka.flash_attention(torch.zeros(2, 3, 160, device=dev), torch.zeros(2, 5, 160, device=dev),
                            torch.zeros(2, 5, 8, device=dev), bias)
    with pytest.raises(ValueError, match="CUDA"):
        pka.flash_attention(q, torch.zeros(2, 5, 16), torch.zeros(2, 5, 8), bias.cpu())
    x = torch.zeros(1, 4, 4, 8, device=dev)
    z = lambda *s: torch.zeros(*s, device=dev)
    bw = pkb.BlockWeights(z(8, 4), z(1, 1, 4), z(3, 3, 4, 4), z(1, 1, 4), z(4, 16), z(1, 1, 16),
                          None, None)
    with pytest.raises(ValueError, match="Cin == Cout"):
        pkb.fused_bottleneck(x, bw, 1)
    bw = pkb.BlockWeights(z(8, 4), z(1, 1, 4), z(3, 3, 4, 4), z(1, 1, 4), z(4, 8), z(1, 1, 8),
                          None, None)
    with pytest.raises(ValueError, match="multiples of 8"):
        pkb.fused_bottleneck(x.bfloat16(), bw, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_model_kernel_forward_matches_cpu_plain_forward(dev, dtype):
    """The whole port at tiny widths: STCATNet with every kernel route on,
    kernels on the card against the plain versions on the CPU. fp32: atol
    2e-4 / rtol 1e-3. bf16, at the learning proof's validation shapes (each
    stream of a 12-frame clip in a bucket of 16: 8 frames, 6 valid): per
    output, the card's relative L2 distance to the CPU's bf16 forward
    (which tests/test_torch_bf16.py holds to the JAX package) within 2 x the
    CPU bf16 forward's own distance to its fp32 one + 2e-4, that test's M
    and F."""
    from stcat_tpu_torch.config import merge_from_list
    from stcat_tpu_torch.core.batch import VideoBatch
    from stcat_tpu_torch.models import build_model

    cfg = merge_from_list(tiny_cfg(), ["TPU.COMPUTE_DTYPE", dtype])
    rng = np.random.RandomState(2)
    b, t, h, w, l = 2, (6 if dtype == "float32" else 8), 64, 64, 7
    frame_valid = np.ones((b, t), bool)
    frame_valid[1, 4:] = False
    if dtype == "bfloat16":
        frame_valid[:, 6:] = False
    pixel_valid = np.ones((b, t, h, w), bool)
    pixel_valid[0, :, 40:] = False
    token_valid = np.ones((b, l), bool)
    token_valid[1, 5:] = False
    arrays = dict(frames=rng.randn(b, t, h, w, 3).astype(np.float32), frame_valid=frame_valid,
                  pixel_valid=pixel_valid, token_ids=rng.randint(3, 100, (b, l)),
                  token_valid=token_valid)
    outs = {}
    runs = [("cpu", "cpu", cfg), ("cuda", "cuda", cfg)]
    if dtype == "bfloat16":
        runs.append(("cpu32", "cpu", merge_from_list(cfg, ["TPU.COMPUTE_DTYPE", "float32"])))
    for name, device, c in runs:
        model = build_model(c, device=device, seed=0)
        batch = VideoBatch(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})
        a0, b0 = pka.LAUNCHES.count, pkb.LAUNCHES.count
        with torch.inference_mode():
            outs[name] = {k: v.float().cpu() for k, v in model(batch).items()
                          if isinstance(v, torch.Tensor)}
        launched = (pka.LAUNCHES.count - a0, pkb.LAUNCHES.count - b0)
        # attention: 2 spatial + 2 temporal encoder layers, 2 + 2 decoder cross
        # attentions; bottleneck: layer1's block (the others are stride-2 firsts)
        assert launched == ((0, 0) if device == "cpu" else (8, 1))
    for key in ("pred_boxes", "pred_sted", "pred_actioness", "weights"):
        card, cpu = outs["cuda"][key], outs["cpu"][key]
        if dtype == "float32":
            np.testing.assert_allclose(card.numpy(), cpu.numpy(), atol=2e-4, rtol=1e-3,
                                       err_msg=key)
            continue
        ref = outs["cpu32"][key]
        own = ((cpu - ref).norm() / ref.norm()).item()
        gap = ((card - cpu).norm() / cpu.norm()).item()
        assert gap <= 2 * own + 2e-4, (key, gap, own)


def _launch_counts():
    return pka.LAUNCHES.count, pka.BWD_LAUNCHES.count, pkb.LAUNCHES.count


@functools.lru_cache(maxsize=None)
def _training_routes(draw: str, seed: int = 0) -> dict:
    """One training forward+backward of the tiny model from ``draw``'s
    weights for ``seed`` by each route: float64 on the CPU (the reference), the CPU's and
    the card's plain versions in fp32, the card's kernels in fp32 (K1, K2,
    K3 and the K3 recompute); {route: (loss, gradients)} and the kernel
    route's launches."""
    cfg = gc.train_cfg()
    batch, targets = gc.train_arrays()
    routes = {"float64": gc.training_grads(
        cfg, gc.fresh_model(cfg, "cpu", draw, seed).double(), batch, targets, torch.float64)}
    routes["cpu"] = gc.training_grads(cfg, gc.fresh_model(cfg, "cpu", draw, seed), batch, targets)
    with plain_kernels():
        routes["card plain"] = gc.training_grads(cfg, gc.fresh_model(cfg, "cuda", draw, seed),
                                                 batch, targets)
    before = _launch_counts()
    routes["card kernels"] = gc.training_grads(cfg, gc.fresh_model(cfg, "cuda", draw, seed),
                                               batch, targets)
    launched = tuple(b - a for a, b in zip(before, _launch_counts()))
    return dict(routes=routes, launched=launched)


def _errors(routes: dict) -> dict:
    ref = routes["float64"][1]
    return {name: gc.route_errors(grads, ref) for name, (_, grads) in routes.items()
            if name != "float64"}


@pytest.mark.parametrize("draw,seed", [
    pytest.param("jax", 0, id="jax"),
    pytest.param("untruncated", 0, id="untruncated"),
    # a draw near a kink: an fp32 route that rounds to its other side reads
    # 1e-4 to 4e-2 from float64 (the card's kernels 1.35e-4 on the backbone's
    # convolutions, another CPU's plain route a median 6.6e-4), where seed 0
    # reads 1e-6
    pytest.param("jax", 6, id="jax_near_a_kink"),
])
def test_tiny_model_training_gradients_on_card_match_cpu(dev, draw, seed):
    """One training forward+backward of the tiny model (layer2 with a
    trainable fused block, every kernel route on, fp32, no dropout), from
    the port's draw ("jax") and from its earlier untruncated one: the loss
    on the card against the CPU at rtol 1e-4; every gradient tensor's
    relative L2 error to the float64 reference by the card's kernels within
    gc.MULTIPLE x the larger of the CPU's and the card's plain fp32 routes'
    errors plus gc.FLOOR (torch_grad_check.py)."""
    res = _training_routes(draw, seed)
    # per microbatch: 8 attention calls (K1, each with a K2 in the backward)
    # and layer1's + layer2's stride-1 blocks (K3)
    assert res["launched"] == (16, 16, 4)
    routes = res["routes"]
    np.testing.assert_allclose(routes["card kernels"][0], routes["cpu"][0], rtol=1e-4)
    for name, grad in routes["cpu"][1].items():
        assert (grad is None) == (routes["card kernels"][1][name] is None), name
    errs = _errors(routes)
    _print_errors(f"{draw} (seed {seed})", errs)
    failures = gc.check_failures(errs["card kernels"], [errs["cpu"], errs["card plain"]])
    assert not failures, [(n, f"{e:.3e}", f"{p:.3e}") for n, e, p in failures[:5]]


def _print_errors(draw: str, errs: dict) -> None:
    names = [n for n in errs["cpu"] if max(e[n] for e in errs.values()) < 1]
    print(f"\n{draw} draw, {len(names)} gradient tensors (and {len(errs['cpu']) - len(names)} "
          "whose exact gradient is 0), relative L2 error to float64:")
    for route, e in errs.items():
        vals = sorted((e[n], n) for n in names)
        print(f"  {route:12s} median {vals[len(vals) // 2][0]:.3e}, largest "
              + ", ".join(f"{n} {v:.3e}" for v, n in vals[::-1][:3]))
    ratio = sorted((errs["card kernels"][n] / max(errs["cpu"][n], errs["card plain"][n]), n)
                   for n in names if max(errs["cpu"][n], errs["card plain"][n]) > 0)
    print(f"  kernels / larger plain: median {ratio[len(ratio) // 2][0]:.3f}, largest "
          + ", ".join(f"{n} {v:.3f}" for v, n in ratio[::-1][:3]))


def test_tiny_model_gradient_check_catches_a_planted_k2_fault(dev):
    """The control of the check above: dk of one K2 call (the last
    spatial-decoder layer's cross-attention in the first microbatch) scaled
    by 1.01 on the card. The check fails at the port's draw; the check it
    replaced (every gradient card vs CPU at atol 2e-4 / rtol 1e-3) fails at
    the untruncated draw."""
    cfg = gc.train_cfg()
    batch, targets = gc.train_arrays()
    planted = {}
    for draw in ("jax", "untruncated"):
        with gc.planted_k2_fault(call=2) as calls:
            planted[draw] = gc.training_grads(cfg, gc.fresh_model(cfg, "cuda", draw), batch,
                                              targets)[1]
        assert len(calls) == 1 and calls[0][2] == 2 * cfg.MODEL.STCAT.HIDDEN // 4, calls
    errs = _errors(_training_routes("jax")["routes"])
    failures = gc.check_failures(gc.route_errors(planted["jax"], _training_routes("jax")[
        "routes"]["float64"][1]), [errs["cpu"], errs["card plain"]])
    print(f"\nplanted dk x 1.01: the check fails on {len(failures)} tensors, worst "
          + ", ".join(f"{n} {e:.3e} (plain {p:.3e})" for n, e, p in failures[:3]))
    assert any(".layers.1.ca_kcontent_proj.weight" in n for n, _, _ in failures), failures[:5]
    cpu = _training_routes("untruncated")["routes"]["cpu"][1]
    old = [n for n, g in cpu.items() if g is not None and not np.allclose(
        planted["untruncated"][n].numpy(), g.numpy(), atol=2e-4, rtol=1e-3)]
    print(f"the earlier check at the untruncated draw fails on {len(old)} tensors: {old[:4]}")
    assert old


def test_prefetch_to_device_orders_copies_before_their_readers(dev):
    """prefetch_to_device on the card: 12 batches of 16 MB each, copied on
    the prefetch stream while the consumer queues a long matmul chain ahead
    of every read and drops each batch at once. Every read sees its batch
    intact: the consumer's stream waits for the copy, and record_stream
    keeps a batch's memory from the next copies until the read has run."""
    from stcat_tpu_torch.core.batch import VideoTargets
    from stcat_tpu_torch.core.prefetch import prefetch_to_device

    n = 1 << 20
    items = [(VideoTargets(boxes=np.full((n, 4), i + 1, np.float32),
                           box_valid=np.ones((n,), bool),
                           actioness=np.arange(n, dtype=np.float32) * (i + 1),
                           temp_bound=np.asarray([[i, i + 1]], np.int32)), i) for i in range(12)]
    busy = torch.randn(2048, 2048, device=dev)
    sums = []
    for targets, i in prefetch_to_device(iter(items), dev, depth=3):
        assert targets.boxes.is_cuda and targets.boxes.shape == (n, 4)
        for _ in range(8):
            busy = torch.tanh(busy @ busy) * 0.5
        sums.append((i, targets.boxes.sum(), targets.actioness[-1].clone(),
                     targets.temp_bound.clone()))
        del targets
    torch.cuda.synchronize()
    assert [i for i, *_ in sums] == list(range(12))
    for i, s, last, bound in sums:
        assert s.item() == 4.0 * n * (i + 1), i
        assert last.item() == float((n - 1) * (i + 1)), i
        assert bound.tolist() == [[i, i + 1]], i


def test_checkpoint_of_card_tensors_restores_bitwise(dev, tmp_path):
    """A TrainState on the card saved without blocking, the next AdamW step
    taken at once in place: the checkpoint holds the state of the save,
    and a fresh card state restored from it equals that state bitwise."""
    from stcat_tpu_torch.models import build_model
    from stcat_tpu_torch.train.checkpoint import Checkpointer
    from stcat_tpu_torch.train.optimizer import make_optimizer
    from stcat_tpu_torch.train.step import create_train_state

    cfg = tiny_cfg()

    def state_on_card(seed):
        model = build_model(cfg, device="cuda", seed=seed)
        return create_train_state(cfg, model, make_optimizer(cfg, model, 10))

    def step(state, scale):
        for p in state.model.parameters():
            p.grad = torch.full_like(p, scale)
        state.optimizer.step()
        with torch.no_grad():
            for n_, p in state.model.named_parameters():
                state.ema[n_].mul_(0.5).add_(p, alpha=0.5)
        state.step += 1

    def flat(state):
        out = {f"m.{k}": v.clone() for k, v in state.model.state_dict().items()}
        out.update({f"e.{k}": v.clone() for k, v in state.ema.items()})
        for i, st in state.optimizer.core.state_dict()["state"].items():
            out.update({f"o.{i}.{k}": torch.as_tensor(v).clone() for k, v in st.items()})
        return out

    state = state_on_card(0)
    step(state, 1.0)
    want = flat(state)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, state)
    step(state, -3.0)
    ckpt.flush()
    fresh, at = ckpt.restore(state_on_card(4))
    assert at == 1 and fresh.optimizer.count == 1
    got = flat(fresh)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device == want[k].device and torch.equal(got[k], want[k]), k


def test_tiny_train_loop_on_card_matches_cpu(dev, tmp_path):
    """train() for 2 iterations of the tiny model (every kernel route on,
    fp32, no dropout, SGD) on the synthetic dataset, on the card and on the
    CPU: parameters and EMA at atol 2e-4 / rtol 1e-3, the tiny-model
    gradient tolerance (SGD moves each weight in proportion to its
    gradient); K1, K2 and K3 launched on the card only."""
    from stcat_tpu_torch.config import merge_from_list
    from stcat_tpu_torch.data.synthetic import make_synthetic_dataset
    from stcat_tpu_torch.train.loop import train

    lrs = [k for g in ("BASE", "TEMP", "TEXT", "VIS_BACKBONE") for k in (f"SOLVER.{g}_LR", 0.5)]
    base = tiny_cfg(["MODEL.VISION_BACKBONE.DEPTHS", "[1,2,1,1]", "MODEL.STCAT.DROPOUT", 0.0,
                     "MODEL.STCAT.HEAD_DROPOUT", 0.0, "MODEL.TEXT_MODEL.DROPOUT", 0.0,
                     "INPUT.RESOLUTION", 64, "INPUT.TRAIN_SAMPLE_NUM", 8,
                     "INPUT.MAX_QUERY_LEN", 12, "TPU.FRAME_BUCKETS", "[8]",
                     "SOLVER.BATCH_SIZE", 2, "SOLVER.MAX_EPOCH", 2, "SOLVER.TO_VAL", "false",
                     "SOLVER.WARMUP_PROP", 0.0, "SOLVER.OPTIMIZER", "sgd", *lrs,
                     "DATALOADER.NUM_WORKERS", 1, "DATA_DIR", str(tmp_path / "data")])
    runs = {}
    for device in ("cpu", "cuda"):
        cfg = merge_from_list(base, ["OUTPUT_DIR", str(tmp_path / device)])
        counts = (pka.LAUNCHES.count, pka.BWD_LAUNCHES.count, pkb.LAUNCHES.count)
        state, it = train(cfg, lambda c, s: make_synthetic_dataset(c, s, n_items=4, n_frames=12),
                          max_iters=2, device=device)
        launched = tuple(c1 - c0 for c0, c1 in zip(counts, (pka.LAUNCHES.count,
                                                             pka.BWD_LAUNCHES.count,
                                                             pkb.LAUNCHES.count)))
        assert it == 2
        # per step (one microbatch of 2 clips): 8 attention calls, each with
        # a K2 in the backward, and layer1's and layer2's stride-1 blocks
        assert launched == ((0, 0, 0) if device == "cpu" else (16, 16, 4))
        runs[device] = state
    for name, p in runs["cpu"].model.named_parameters():
        np.testing.assert_allclose(runs["cuda"].model.state_dict()[name].cpu().numpy(),
                                   p.detach().numpy(), atol=2e-4, rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(runs["cuda"].ema[name].cpu().numpy(),
                                   runs["cpu"].ema[name].numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=name)


def _tiny_clips(cfg, b=2, t=8, seed=5):
    """A raw batch of b seeded 48x64 clips with spans, boxes and sentences."""
    from stcat_tpu_torch.data.batching import build_raw_batch
    from stcat_tpu_torch.data.tokenize import HashTokenizer
    from stcat_tpu_torch.data.transforms import build_transforms

    rng = np.random.RandomState(seed)
    transform = build_transforms(cfg)
    samples = []
    for i in range(b):
        act = np.zeros(t, np.float32)
        act[1 + i: 4 + i] = 1.0
        plan, _, text = transform.plan((48, 64), np.zeros((0, 4), np.float32), f"clip {i} walks")
        samples.append({"frames_u8": rng.randint(0, 256, (t, 48, 64, 3), dtype=np.uint8),
                        "plan": plan, "text": text, "actioness": act,
                        "boxes_cxcywh": rng.uniform(0.2, 0.6, (3, 4)).astype(np.float32)})
    return build_raw_batch(samples, t, HashTokenizer(cfg.MODEL.TEXT_MODEL.VOCAB_SIZE), 12)


def test_train_step_and_eval_wait_for_the_card_only_to_drain(dev, tmp_path, monkeypatch):
    """Under torch.cuda.set_sync_debug_mode("error") (any host wait on the
    card raises): one make_train_step step at GRAD_ACCUM 2 from host arrays,
    and do_eval in both TPU.EVAL_DEVICE_SPLIT variants up to its first
    drain, whose device-to-host read is the one wait the JAX engine has
    too. Then the eval pass finishes with its metrics in [0, 1]."""
    from stcat_tpu_torch.config import merge_from_list
    from stcat_tpu_torch.data.loader import Loader
    from stcat_tpu_torch.data.synthetic import write_synthetic_cache, SyntheticDataset
    from stcat_tpu_torch.eval import engine
    from stcat_tpu_torch.eval.evaluator import build_evaluator
    from stcat_tpu_torch.models import build_model
    from stcat_tpu_torch.train.optimizer import make_optimizer
    from stcat_tpu_torch.train.step import create_train_state, make_train_step

    cfg = tiny_cfg(["MODEL.STCAT.DROPOUT", 0.0, "TPU.GRAD_ACCUM", 2, "INPUT.RESOLUTION", 64,
                    "INPUT.MAX_QUERY_LEN", 12, "TPU.FRAME_BUCKETS", "[8]",
                    "DATA_DIR", str(tmp_path)])
    model = build_model(cfg, device="cuda", seed=0)
    opt = make_optimizer(cfg, model, num_training_steps=10)
    state = create_train_state(cfg, model, opt)
    step = make_train_step(cfg, model, opt)
    raw, targets, _ = _tiny_clips(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(state, raw, targets, gen)  # first step: kernels built, optimizer state made
    torch.cuda.synchronize()
    counts = pka.BWD_LAUNCHES.count
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = step(state, raw, targets, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pka.BWD_LAUNCHES.count - counts == 16 and np.isfinite(losses["loss"].item())

    write_synthetic_cache(str(tmp_path), "VidSTG", "test", n_items=5, n_frames=12)
    real = engine.to_host
    drains = []

    def to_host(tensors):
        drains.append(torch.cuda.get_sync_debug_mode())
        torch.cuda.set_sync_debug_mode("default")
        return real(tensors)

    monkeypatch.setattr(engine, "to_host", to_host)
    for split in ("true", "false"):
        c = merge_from_list(cfg, ["TPU.EVAL_DEVICE_SPLIT", split])
        loader = Loader(c, SyntheticDataset(c, "test"), global_batch=1, is_train=False)
        drains.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = engine.do_eval(c, model, loader, build_evaluator(c))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert drains[0] == 2  # the first drain came with "error" still set
        assert all(0.0 <= v <= 1.0 for v in res.values())


def test_lstm_variant_on_card_matches_cpu(dev):
    """MODEL.USE_LSTM at tiny widths, fp32, every kernel route on: the
    forward on the card (K1, K3, cuDNN's LSTM) against the CPU's plain one
    at atol 2e-4 / rtol 1e-3, and one training forward+backward's LSTM
    gradients at the same tolerance (``bias_ih_l0`` gets none on either
    side), K2 launched on the card."""
    from stcat_tpu_torch.core.batch import to_device
    from stcat_tpu_torch.models import build_model
    from stcat_tpu_torch.ops.preprocess import preprocess
    from stcat_tpu_torch.train.optimizer import make_optimizer
    from stcat_tpu_torch.train.step import accumulate_grads

    cfg = tiny_cfg(["MODEL.USE_LSTM", "true", "MODEL.LSTM.HIDDEN_SIZE", 32,
                    "MODEL.LSTM.EMBED_DIM", 24, "MODEL.STCAT.DROPOUT", 0.0,
                    "MODEL.STCAT.HEAD_DROPOUT", 0.0, "INPUT.RESOLUTION", 64,
                    "INPUT.MAX_QUERY_LEN", 12, "TPU.FRAME_BUCKETS", "[8]"])
    raw, targets, _ = _tiny_clips(cfg)
    outs, grads = {}, {}
    for device in ("cpu", "cuda"):
        model = build_model(cfg, device=device, seed=0)
        placed = to_device(raw, device)
        counts = (pka.LAUNCHES.count, pka.BWD_LAUNCHES.count, pkb.LAUNCHES.count)
        with torch.inference_mode():
            outs[device] = model(preprocess(placed, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD))
        accumulate_grads(cfg, model, make_optimizer(cfg, model, 10), placed,
                         to_device(targets, device), torch.Generator(device).manual_seed(0))
        launched = tuple(c1 - c0 for c0, c1 in zip(counts, (pka.LAUNCHES.count,
                                                             pka.BWD_LAUNCHES.count,
                                                             pkb.LAUNCHES.count)))
        assert launched == ((0, 0, 0) if device == "cpu" else (16, 8, 2))
        grads[device] = {n: p.grad for n, p in model.named_parameters()
                         if n.startswith("text_encoder.")}
    for key in ("pred_boxes", "pred_sted", "pred_actioness"):
        np.testing.assert_allclose(outs["cuda"][key].cpu().numpy(), outs["cpu"][key].numpy(),
                                   atol=2e-4, rtol=1e-3, err_msg=key)
    for name, g in grads["cpu"].items():
        if name.endswith("bias_ih_l0"):  # no gradient: one bias per gate, as flax's cell
            assert g is None and grads["cuda"][name] is None, name
            continue
        np.testing.assert_allclose(grads["cuda"][name].cpu().numpy(), g.numpy(), atol=2e-4,
                                   rtol=1e-3, err_msg=name)


def test_serve_cli_round_trip_on_card(dev):
    """cli.serve's build_server on the card: a POSTed clip's answer against
    the CPU predictor with the same seeded weights (boxes within 0.5 px, the
    same span), K1 and K3 launched, K2 not."""
    import http.client
    import io
    import json
    import threading

    from stcat_tpu_torch.cli.serve import build_server
    from stcat_tpu_torch.serve import GroundingPredictor

    cfg = tiny_cfg(["INPUT.RESOLUTION", 64, "INPUT.MAX_QUERY_LEN", 12, "TPU.FRAME_BUCKETS", "[8]"])
    server, batcher = build_server(cfg, "127.0.0.1", 0, max_batch=2, max_wait_ms=5.0,
                                   device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    clip = np.random.RandomState(3).randint(0, 256, (12, 48, 64, 3), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, frames=clip, text=np.array("a person waves"))
    counts = (pka.LAUNCHES.count, pka.BWD_LAUNCHES.count, pkb.LAUNCHES.count)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
        conn.request("POST", "/predict", buf.getvalue())
        resp = conn.getresponse()
        got = json.loads(resp.read())
        conn.close()
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=10)
    assert resp.status == 200
    launched = tuple(c1 - c0 for c0, c1 in zip(counts, (pka.LAUNCHES.count,
                                                         pka.BWD_LAUNCHES.count,
                                                         pkb.LAUNCHES.count)))
    assert launched[0] > 0 and launched[1] == 0 and launched[2] > 0
    want = GroundingPredictor(cfg, max_batch=2, device="cpu").predict(clip, "a person waves")
    assert got["span"] == list(want["span"])
    for fid, box in want["boxes"].items():
        np.testing.assert_allclose(got["boxes"][str(fid)], box, atol=0.5, rtol=0)


def _yuv_raw(seed, flips, sizes):
    """A yuv420 raw batch (numpy) of coloured clips of the given (t, h, w)
    (odd sizes allowed) with eval plans and the given flips."""
    from stcat_tpu_torch.data.batching import build_raw_batch
    from stcat_tpu_torch.data.decode import rgb_to_yuv420
    from stcat_tpu_torch.data.tokenize import HashTokenizer
    from stcat_tpu_torch.data.transforms import VideoTransform

    rng = np.random.RandomState(seed)
    samples = []
    for i, ((t, h, w), flip) in enumerate(zip(sizes, flips)):
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        rgb = np.stack([60 + 2 * xx, 40 + 3 * yy, 120 + xx - yy], -1)[None] \
            + rng.randint(-20, 21, (t, h, w, 3))
        y, cbcr = rgb_to_yuv420(np.clip(rgb, 0, 255).astype(np.uint8))
        plan, _, text = VideoTransform(64).plan((h, w), np.zeros((0, 4), np.float32), f"c {i}")
        samples.append({"frames_y": y, "frames_cbcr": cbcr, "text": text,
                        "plan": dataclasses.replace(plan, flip=flip)})
    return build_raw_batch(samples, max(t for t, _, _ in sizes), HashTokenizer(128), 8)[0]


def test_yuv_preprocess_on_card_matches_cpu(dev):
    """The yuv420 branch of preprocess (flip, luma and chroma resample, the
    BT.601 conversion, normalise, masks) on the card against the same
    function on the CPU at atol 1e-5, flipped and unflipped clips of odd
    sizes; TF32 is off, so both sum in fp32."""
    from stcat_tpu_torch.core.batch import to_device
    from stcat_tpu_torch.ops.preprocess import preprocess

    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    raw = _yuv_raw(0, [True, False, True], [(5, 37, 53), (4, 240, 320), (5, 63, 35)])
    got = preprocess(to_device(raw, dev), mean, std)
    want = preprocess(to_device(raw, torch.device("cpu")), mean, std)
    assert got.frames.device.type == dev.type
    np.testing.assert_allclose(got.frames.cpu().numpy(), want.frames.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(got.pixel_valid.cpu(), want.pixel_valid)


def test_host_path_eval_frames_match_the_device_rgb_path(dev, tmp_path):
    """The same synthetic test split through the loader twice: with
    TPU.DEVICE_PREPROCESS false (the host replays each clip's eval resize on
    float32 frames) and with the raw rgb path, whose batch crosses through
    prefetch_to_device and is preprocessed on the card. The frames agree at
    atol 5e-4 (normalised units; tests/test_device_preprocess.py's eval
    tolerance), the masks exactly; the host batch's float32 frames cross
    through the prefetch too."""
    from stcat_tpu_torch.config import merge_from_list
    from stcat_tpu_torch.core.prefetch import prefetch_to_device
    from stcat_tpu_torch.data.loader import Loader
    from stcat_tpu_torch.data.synthetic import SyntheticDataset, write_synthetic_cache
    from stcat_tpu_torch.ops.preprocess import preprocess

    write_synthetic_cache(str(tmp_path), "VidSTG", "test", n_items=3, n_frames=10,
                          vary_geometry=True)
    base = tiny_cfg(["DATA_DIR", str(tmp_path), "INPUT.RESOLUTION", 64,
                     "INPUT.MAX_QUERY_LEN", 12, "TPU.FRAME_BUCKETS", "[16]"])
    host_cfg = merge_from_list(base, ["TPU.DEVICE_PREPROCESS", "false"])
    host = list(Loader(host_cfg, SyntheticDataset(host_cfg, "test"), 1, False))
    raw = list(Loader(base, SyntheticDataset(base, "test"), 1, False))
    assert len(host) == len(raw) == 3
    for (hb, _, _), (rb, _, _) in zip(prefetch_to_device(iter(host), dev),
                                      prefetch_to_device(iter(raw), dev)):
        assert hb.frames.device.type == dev.type and hb.frames.dtype == torch.float32
        got = preprocess(rb, base.INPUT.PIXEL_MEAN, base.INPUT.PIXEL_STD)
        assert got.frames.shape == hb.frames.shape
        np.testing.assert_allclose(got.frames.cpu().numpy(), hb.frames.cpu().numpy(),
                                   atol=5e-4, rtol=0)
        assert torch.equal(got.pixel_valid, hb.pixel_valid)


def _mix_requests(frames=128, seed=0):
    """Two requests of the serving mix's shape: 320 x 240 clips of
    ``frames`` frames (two streams of frames / 2 each)."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (frames, 240, 320, 3), dtype=np.uint8),
             f"the person {i} walks to the left", None) for i in range(2)]


def test_staged_frames_are_pinned_and_placed_bit_for_bit_at_the_mix_shape(dev):
    """At the serving mix's shape (2 lanes x 2 streams x 64 frames of 240 x
    320): every staged canvas is page-locked, and the placed batch equals
    to_device(build_raw_batch(...)) bit for bit, though the staged sources
    are dropped as soon as their copies are queued (behind a chain of
    matmuls) and fresh page-locked buffers of their size are written at
    once: the caching host allocator keeps a canvas until its copy is done."""
    import dataclasses

    from stcat_tpu_torch.serve import GroundingPredictor
    from torch_staging import built_before_staging, staged

    cfg = tiny_cfg(["INPUT.RESOLUTION", 448, "TPU.FRAME_BUCKETS", "[64]"])
    pred = GroundingPredictor(cfg, max_batch=2, device="cuda")
    reqs = _mix_requests()
    want, w1, w2 = built_before_staging(pred, reqs)
    ahead = staged(pred, reqs)
    canvases = [s["canvas"] for r in ahead for s in r.staged.result().streams]
    assert len(canvases) == 4 and all(c.is_pinned() for c in canvases)
    assert canvases[0].shape == (64, 256, 320, 3)
    shape = canvases[0].shape
    del canvases
    busy = torch.randn(4096, 4096, device=dev)
    for _ in range(30):
        busy = torch.tanh(busy @ busy)
    raw, m1, m2 = pred.prepare(ahead)
    got = pred.place(raw)
    del ahead, raw
    scribbled = [torch.full(shape, 7, dtype=torch.uint8, pin_memory=True) for _ in range(8)]
    torch.cuda.synchronize()
    assert (m1, m2) == (w1, w2) and got.frames_u8.shape == (4, 64, 256, 320, 3)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    del scribbled


def test_peak_card_memory_of_predict_batch_is_the_same_staged_or_not(dev):
    """torch.cuda.max_memory_allocated over one predict_batch of two
    16-frame 320 x 240 requests: the same with the batch built as before
    staging (build_raw_batch + to_device), staged in prepare, and staged
    ahead as MicroBatcher.submit stages it."""
    from stcat_tpu_torch.core.batch import to_device
    from stcat_tpu_torch.serve import GroundingPredictor
    from torch_staging import built_before_staging, staged

    cfg = tiny_cfg(["INPUT.RESOLUTION", 64, "INPUT.MAX_QUERY_LEN", 12, "TPU.FRAME_BUCKETS", "[8]"])
    pred = GroundingPredictor(cfg, max_batch=2, device="cuda")
    reqs = _mix_requests(frames=16, seed=1)
    pred.predict_batch(reqs)  # kernels built, weights folded
    peaks = {}
    for route in ("before", "unstaged", "staged"):
        batch = staged(pred, reqs) if route == "staged" else reqs
        if route == "before":
            pred.prepare = lambda r: built_before_staging(pred, r, place=False)
            pred.place = lambda raw: to_device(raw, pred.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        pred.predict_batch(batch)
        torch.cuda.synchronize()
        peaks[route] = torch.cuda.max_memory_allocated(dev) - base
        if route == "before":
            del pred.prepare, pred.place
    assert peaks["unstaged"] == peaks["staged"] == peaks["before"] > 0, peaks
