"""Port kernels: the plain PyTorch versions against the JAX package's kernels.

``attention_plain`` is held against ``_xla_attention`` and against the Pallas
``_flash_fwd`` run in interpret mode; ``attention_bwd_plain`` against the
Pallas ``_flash_bwd`` in interpret mode and against ``jax.vjp`` of
``_xla_attention``; ``bottleneck_plain`` against ``bottleneck_reference`` and
the interpreted ``_fused_fwd``; the two autograd Functions' gradients on CPU
tensors against autograd through the plain versions and against ``jax.vjp``
of the JAX package's ``fused_bottleneck``; the bottleneck's bf16 backward
against the fp32 ``jax.vjp`` (the JAX package's bf16 one raises, which a
case pins). Inputs are numpy arrays from a seed handed to both. Tolerance:
fp32, atol 2e-5, as in tests/test_kernels.py (summation order only); the
attention plain versions in bf16 against the Pallas kernels in bf16, 2e-2
of the largest output; the bf16 bottleneck gradients BF16_GRAD_TOL.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
compares them with their plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stcat_tpu.kernels.attention as ka
import stcat_tpu.kernels.conv as kconv
from stcat_tpu_torch.kernels import attention as pka
from stcat_tpu_torch.kernels import bottleneck as pkb

ATOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    old = ka._INTERPRET, kconv._INTERPRET
    ka._INTERPRET = kconv._INTERPRET = True
    yield
    ka._INTERPRET, kconv._INTERPRET = old


def attn_inputs(bh, sq, sk, dk, dv, seed=0, tail=9, full_row=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, sq, dk).astype(np.float32)
    k = rng.randn(bh, sk, dk).astype(np.float32)
    v = rng.randn(bh, sk, dv).astype(np.float32)
    bias = np.zeros((bh, sk), np.float32)
    bias[:, sk - tail:] = -1e30  # padded tail keys
    bias[0, min(3, sk - 1)] = -1e30
    if full_row:
        bias[1, :] = -1e30       # a fully masked head row
    return q, k, v, bias


ATTN_CASES = [
    (4, 37, 53, 32, 32),    # padded tail keys (tests/test_kernels.py)
    (8, 1, 223, 32, 32),    # decoder cross-attention: Sq = 1
    (2, 130, 300, 32, 32),  # several k-blocks
    (8, 1, 53, 64, 32),     # concat cross-attention: Dk = 2 * Dv
    (8, 8, 896, 32, 32),    # tiny Sq, long Sk
    (3, 8, 17, 32, 32),     # the card kernels' edges: Sq of a partial 64-row tile,
    (2, 15, 293, 32, 32),   # Sk no multiple of 64, Sq = Sk, odd head widths
    (2, 65, 65, 32, 32),
    (2, 64, 40, 100, 70),
]


@pytest.mark.parametrize("bh,sq,sk,dk,dv", ATTN_CASES)
def test_attention_plain_matches_xla_and_pallas(bh, sq, sk, dk, dv):
    q, k, v, bias = attn_inputs(bh, sq, sk, dk, dv)
    ours = pka.attention_plain(*map(torch.from_numpy, (q, k, v, bias))).numpy()
    jargs = tuple(map(jnp.asarray, (q, k, v, bias)))
    np.testing.assert_allclose(ours, np.asarray(ka._xla_attention(*jargs)), atol=ATOL)
    np.testing.assert_allclose(ours, np.asarray(ka._flash_fwd(*jargs)), atol=ATOL)


def test_attention_fully_masked_row_averages_real_keys():
    """A row whose keys are all masked averages v over the REAL Sk keys, as
    _xla_attention does (the Pallas kernel also averages over its padding,
    so it is compared on the other rows only)."""
    q, k, v, bias = attn_inputs(4, 5, 20, 32, 32, full_row=True)
    ours = pka.attention_plain(*map(torch.from_numpy, (q, k, v, bias))).numpy()
    jargs = tuple(map(jnp.asarray, (q, k, v, bias)))
    np.testing.assert_allclose(ours, np.asarray(ka._xla_attention(*jargs)), atol=ATOL)
    np.testing.assert_allclose(ours[1], np.broadcast_to(v[1].mean(0), ours[1].shape), atol=ATOL)
    keep = [0, 2, 3]
    np.testing.assert_allclose(ours[keep], np.asarray(ka._flash_fwd(*jargs))[keep], atol=ATOL)


def test_attention_wrapper_on_cpu_runs_plain_without_launch():
    q, k, v, bias = map(torch.from_numpy, attn_inputs(2, 7, 11, 16, 8))
    before = pka.LAUNCHES.count
    out = pka.flash_attention(q, k, v, bias)
    assert pka.LAUNCHES.count == before == 0
    torch.testing.assert_close(out, pka.attention_plain(q, k, v, bias), rtol=0, atol=0)


BWD_CASES = [  # Sq not a multiple of 8, Sk not of 128, Dk != Dv both ways
    (4, 37, 53, 32, 32),
    (8, 1, 223, 32, 32),
    (8, 1, 53, 64, 32),
    (2, 13, 140, 16, 24),
    (3, 8, 17, 32, 32),
    (2, 15, 293, 32, 32),
    (2, 65, 65, 32, 32),
    (2, 64, 40, 100, 70),
]


@pytest.mark.parametrize("bh,sq,sk,dk,dv", BWD_CASES)
def test_attention_bwd_plain_matches_pallas_flash_bwd(bh, sq, sk, dk, dv):
    q, k, v, bias = attn_inputs(bh, sq, sk, dk, dv)
    g = np.random.RandomState(1).randn(bh, sq, dv).astype(np.float32)
    ours = pka.attention_bwd_plain(*map(torch.from_numpy, (q, k, v, bias, g)))
    theirs = ka._flash_bwd(*map(jnp.asarray, (q, k, v, bias, g)))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)


# bf16: the plain versions round where the Pallas kernels do (q * scale, p or
# w, d(logits), dq before its unscaling, dbias through k's dtype); what is
# left is fp32 summation order showing through the bf16 outputs, about two
# bf16 ulps of the largest output at most, the card tests' bf16 tolerance
BF16_TOL = 2e-2
BF16_CASES = [(4, 37, 53, 32, 32), (4, 1, 292, 64, 32), (3, 8, 17, 32, 32), (2, 15, 293, 32, 32),
              (2, 65, 65, 32, 32), (2, 64, 40, 100, 70)]


def _bf16_rel(ours, theirs, floor):
    a, b = ours.float().numpy(), np.asarray(theirs.astype(jnp.float32))
    return np.abs(a - b).max() / max(floor, np.abs(b).max())


@pytest.mark.parametrize("bh,sq,sk,dk,dv", BF16_CASES)
def test_attention_plain_bf16_matches_pallas_flash_fwd(bh, sq, sk, dk, dv):
    q, k, v, bias = attn_inputs(bh, sq, sk, dk, dv)
    ours = pka.attention_plain(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                               torch.from_numpy(bias))
    theirs = ka._flash_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(bias))
    assert ours.dtype == torch.bfloat16
    assert _bf16_rel(ours, theirs, 1.0) <= BF16_TOL


@pytest.mark.parametrize("bh,sq,sk,dk,dv", BF16_CASES)
def test_attention_bwd_plain_bf16_matches_pallas_flash_bwd(bh, sq, sk, dk, dv):
    """Each of dq, dk, dv, dbias against its own max |Pallas| (the gradients
    are far below 1)."""
    q, k, v, bias = attn_inputs(bh, sq, sk, dk, dv)
    g = np.random.RandomState(1).randn(bh, sq, dv).astype(np.float32)
    ours = pka.attention_bwd_plain(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                   torch.from_numpy(bias), torch.from_numpy(g).bfloat16())
    theirs = ka._flash_bwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                           jnp.asarray(bias), jnp.asarray(g, jnp.bfloat16))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), ours, theirs):
        assert _bf16_rel(a, b, 0.0) <= BF16_TOL, name


@pytest.mark.parametrize("bh,sq,sk,dk,dv", [(4, 5, 20, 32, 32), (4, 1, 20, 64, 32)])
def test_attention_bwd_plain_matches_xla_vjp_with_fully_masked_rows(bh, sq, sk, dk, dv):
    """Row 1 of every head has all keys masked: its weights are uniform over
    the real keys and its gradients are those of _xla_attention (the Pallas
    backward would spread them over its padded keys too)."""
    q, k, v, bias = attn_inputs(bh, sq, sk, dk, dv, full_row=True)
    g = np.random.RandomState(2).randn(bh, sq, dv).astype(np.float32)
    ours = pka.attention_bwd_plain(*map(torch.from_numpy, (q, k, v, bias, g)))
    _, vjp = jax.vjp(ka._xla_attention, *map(jnp.asarray, (q, k, v, bias)))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), ours, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("bh,sq,sk,dk,dv", ATTN_CASES)
def test_attention_function_grads_on_cpu_match_autograd_through_plain(bh, sq, sk, dk, dv):
    arrays = attn_inputs(bh, sq, sk, dk, dv, full_row=True)
    g = torch.from_numpy(np.random.RandomState(3).randn(bh, sq, dv).astype(np.float32))
    grads = []
    for fn in (pka.flash_attention, pka.attention_plain):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        fn(*ts).backward(g)
        grads.append([t.grad for t in ts])
    assert pka.LAUNCHES.count == pka.BWD_LAUNCHES.count == 0
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), *grads):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL, msg=name)


def test_attention_function_skips_dbias_unless_asked():
    q, k, v, bias = (torch.from_numpy(a) for a in attn_inputs(2, 7, 11, 16, 8))
    q.requires_grad_()
    pka.flash_attention(q, k, v, bias).sum().backward()
    assert q.grad is not None and bias.grad is None


def make_block(rng, cin, p, ds, scale=0.1):
    cout = 4 * p
    mk = lambda *s: rng.randn(*s).astype(np.float32) * scale
    return dict(w1=mk(cin, p), b1=mk(1, 1, p), w2=mk(3, 3, p, p), b2=mk(1, 1, p),
                w3=mk(p, cout), b3=mk(1, 1, cout),
                wd=mk(cin, cout) if ds else None, bd=mk(1, 1, cout) if ds else None)


def _jax_block(arrs):
    return kconv.BlockWeights(**{k: None if v is None else jnp.asarray(v) for k, v in arrs.items()})


def _port_block(arrs):
    return pkb.BlockWeights(**{k: None if v is None else torch.from_numpy(v)
                               for k, v in arrs.items()})


BOTTLENECK_CASES = [
    (2, 8, 8, 16, 8, True, 1),     # layer1 block0 shape class (projection)
    (1, 8, 6, 32, 8, False, 1),    # identity skip, non-square
    (1, 10, 10, 32, 8, False, 2),  # DC5 dilated block
]


@pytest.mark.parametrize("n,h,w,cin,p,ds,dil", BOTTLENECK_CASES)
def test_bottleneck_plain_matches_reference_and_pallas(n, h, w, cin, p, ds, dil):
    rng = np.random.RandomState(0)
    arrs = make_block(rng, cin, p, ds)
    x = (rng.randn(n, h, w, cin) * 0.5).astype(np.float32)
    ours = pkb.bottleneck_plain(torch.from_numpy(x), _port_block(arrs), dil).numpy()
    jx, jb = jnp.asarray(x), _jax_block(arrs)
    np.testing.assert_allclose(ours, np.asarray(kconv.bottleneck_reference(jx, jb, dil)), atol=ATOL)
    np.testing.assert_allclose(ours, np.asarray(kconv._fused_fwd(jx, jb, dil)), atol=ATOL)


@pytest.mark.parametrize("n,h,w,cin,p,ds,dil", BOTTLENECK_CASES)
def test_bottleneck_function_grads_match_jax_vjp(n, h, w, cin, p, ds, dil):
    """The Function's backward (a recompute of bottleneck_plain under
    autograd) against jax.vjp of the JAX package's fused_bottleneck, whose
    forward is the interpreted Pallas kernel and whose backward is its
    _vjp_bwd recompute of bottleneck_reference."""
    rng = np.random.RandomState(4)
    arrs = make_block(rng, cin, p, ds)
    x = (rng.randn(n, h, w, cin) * 0.5).astype(np.float32)
    g = rng.randn(n, h, w, 4 * p).astype(np.float32)
    out, vjp = jax.vjp(lambda x_, p_: kconv.fused_bottleneck(x_, p_, dil), jnp.asarray(x),
                       _jax_block(arrs))
    dx_j, dp_j = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_()
    bw = pkb.BlockWeights(**{k: None if v is None else torch.from_numpy(v).requires_grad_()
                             for k, v in arrs.items()})
    ours = pkb.fused_bottleneck(tx, bw, dil)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(out), atol=ATOL)
    ours.backward(torch.from_numpy(g))
    assert pkb.LAUNCHES.count == 0
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx_j), atol=ATOL, err_msg="dx")
    for name in pkb.BlockWeights._fields:
        ours_w, theirs_w = getattr(bw, name), getattr(dp_j, name)
        if ours_w is None:
            assert theirs_w is None
            continue
        # weight grads sum over N*H*W positions: atol scaled by the largest
        scale = max(1.0, float(np.abs(np.asarray(theirs_w)).max()))
        np.testing.assert_allclose(ours_w.grad.numpy(), np.asarray(theirs_w), atol=ATOL * scale,
                                   err_msg=name)


def _bf16_round(a):
    return None if a is None else torch.from_numpy(a).bfloat16().float().numpy()


# Largest |port - JAX| / max |JAX| of each bf16 gradient below. Where no
# ReLU input of the block lies within a bf16 rounding of 0 the readings are
# 2e-3 to 5e-3, about one bf16 rounding (2^-8 = 3.9e-3). Where one does, the
# two forwards can disagree on its sign (the bf16 one rounds x1 before the
# 3x3 conv): the test equalises the last ReLU's mask, not y2's, and the
# projection case's w1, b1, w2, b2 read 1.1e-2 to 1.5e-2.
BF16_GRAD_TOL = 2e-2


@pytest.mark.parametrize("n,h,w,cin,p,ds,dil", BOTTLENECK_CASES)
def test_bottleneck_function_bf16_grads_match_jax_fp32_vjp(n, h, w, cin, p, ds, dil):
    """The Function's backward on bf16 CPU tensors (x and the cotangent in
    bf16, fp32 weights; the recompute of bottleneck_plain rounds x1, y2 and
    the output to bf16 as the forward does) against jax.vjp of
    bottleneck_reference in fp32 on the same bf16-rounded inputs: the JAX
    package has no bf16 gradient to compare with (the next test). Output
    elements where the bf16 forward and the fp32 one disagree on the last
    ReLU's sign get a zero cotangent on both sides; every gradient within
    BF16_GRAD_TOL of its largest element."""
    rng = np.random.RandomState(4)
    arrs = {k: _bf16_round(v) for k, v in make_block(rng, cin, p, ds).items()}
    x = _bf16_round((rng.randn(n, h, w, cin) * 0.5).astype(np.float32))
    g = _bf16_round(rng.randn(n, h, w, 4 * p).astype(np.float32))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    bw = pkb.BlockWeights(**{k: None if v is None else torch.from_numpy(v).requires_grad_()
                             for k, v in arrs.items()})
    ours = pkb.fused_bottleneck(tx, bw, dil)
    out, vjp = jax.vjp(lambda x_, p_: kconv.bottleneck_reference(x_, p_, dil), jnp.asarray(x),
                       _jax_block(arrs))
    g = g * ((ours.detach().float().numpy() > 0) == (np.asarray(out) > 0))
    dx_j, dp_j = vjp(jnp.asarray(g))
    ours.backward(torch.from_numpy(g).bfloat16())
    assert pkb.LAUNCHES.count == 0 and tx.grad.dtype == torch.bfloat16
    pairs = {"dx": (tx.grad.float(), dx_j)}
    pairs.update({k: (getattr(bw, k).grad, getattr(dp_j, k)) for k in pkb.BlockWeights._fields
                  if getattr(bw, k) is not None})
    for name, (got, want) in pairs.items():
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=BF16_GRAD_TOL * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("weights", ["float32", "bfloat16"])
def test_jax_bottleneck_bf16_vjp_raises(weights):
    """The JAX package's own bf16 backward of the block cannot run:
    jax.vjp of bottleneck_reference (what fused_bottleneck's _vjp_bwd
    recomputes) with x in bf16 raises TypeError in the transposed
    convolution (lax.conv_general_dilated with bfloat16 and float32
    operands), with fp32 or bf16 weights; so the port's bf16 backward is
    held to the fp32 gradients above. This case fails, and should be turned
    round into a comparison of the two bf16 backwards, once the JAX side
    runs in bf16."""
    rng = np.random.RandomState(4)
    arrs = make_block(rng, 16, 8, True)
    x = jnp.asarray(rng.randn(2, 8, 8, 16), jnp.bfloat16)
    block = kconv.BlockWeights(**{k: None if v is None else jnp.asarray(v, weights)
                                  for k, v in arrs.items()})
    _, vjp = jax.vjp(lambda x_, p_: kconv.bottleneck_reference(x_, p_, 1), x, block)
    with pytest.raises(TypeError, match="same dtypes"):
        vjp(jnp.ones((2, 8, 8, 32), jnp.bfloat16))


def test_bottleneck_function_grads_only_for_what_requires_them():
    rng = np.random.RandomState(5)
    bw = _port_block(make_block(rng, 16, 8, True))
    bw.w2.requires_grad_()
    x = torch.from_numpy(rng.randn(1, 5, 4, 16).astype(np.float32))
    pkb.fused_bottleneck(x, bw, 1).sum().backward()
    assert bw.w2.grad is not None and x.grad is None and bw.w1.grad is None


def test_bottleneck_plain_matches_pallas_row_chunks(monkeypatch):
    """The Pallas kernel split into row chunks (halo branches) agrees too."""
    rng = np.random.RandomState(1)
    arrs = make_block(rng, 32, 8, False)
    x = rng.randn(1, 12, 8, 32).astype(np.float32)
    monkeypatch.setattr(kconv, "_TILE_BUDGET", 24 * 1024)
    assert kconv._pick_chunks(12, 8, 32, 8, 32, 1) > 1
    pallas = np.asarray(kconv._fused_fwd(jnp.asarray(x), _jax_block(arrs), 1))
    ours = pkb.bottleneck_plain(torch.from_numpy(x), _port_block(arrs), 1).numpy()
    np.testing.assert_allclose(ours, pallas, atol=ATOL)


@pytest.mark.parametrize("packed", [False, True])
def test_bottleneck_wrapper_on_cpu_runs_plain_without_launch(packed):
    """BlockWeights, or weights ``pack``ed once for a forward without
    gradient (which refuses one with gradients on)."""
    rng = np.random.RandomState(2)
    bw = _port_block(make_block(rng, 16, 8, True))
    x = torch.from_numpy(rng.randn(1, 6, 5, 16).astype(np.float32))
    if packed:
        with pytest.raises(ValueError, match="without gradient"):
            pkb.fused_bottleneck(x, pkb.pack(bw, x.dtype), 1)
        with torch.no_grad():
            out = pkb.fused_bottleneck(x, pkb.pack(bw, x.dtype), 1)
    else:
        out = pkb.fused_bottleneck(x, bw, 1)
    assert pkb.LAUNCHES.count == 0
    torch.testing.assert_close(out, pkb.bottleneck_plain(x, bw, 1), rtol=0, atol=0)


# the main path's stride-1 blocks (R101 at 448x608) and a DC5 layer4 block:
# h, w, cin, p, dilation, projection
MAIN_STAGES = [
    (112, 152, 64, 64, 1, True),
    (112, 152, 256, 64, 1, False),
    (56, 76, 512, 128, 1, False),
    (28, 38, 1024, 256, 1, False),
    (14, 19, 2048, 512, 1, False),
]
DC5_LAYER4 = (28, 38, 2048, 512, 2, False)


def _tile_work(h, w, cin, p, d, proj, ch, cw, itemsize):
    """GEMM work of a tile plan, tile by tile: x1 over each haloed tile and
    phases 2-3 over each tile, rows rounded up to the GEMMs' BM on the bf16
    route: 128 where P <= 256 (the two warpgroups split M), else 64."""
    g = (128 if p <= 256 else 64) if itemsize == 2 else 1
    ru = lambda m: -(-m // g) * g
    total = 0
    for r0 in range(0, h, ch):
        r = min(ch, h - r0)
        for c0 in range(0, w, cw):
            c = min(cw, w - c0)
            total += ru((r + 2 * d) * (c + 2 * d)) * cin * p
            total += ru(r * c) * (9 * p * p + 4 * p * p + (cin * 4 * p if proj else 0))
    return total


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("h,w,cin,p,d,proj", MAIN_STAGES + [DC5_LAYER4])
def test_bottleneck_tile_fits_shared_memory(h, w, cin, p, d, proj, itemsize):
    """The picked tile and ring fit 227 KB; no tile that fits the same ring
    does less work; the ring is the deepest of RINGS whose best tile does at
    most 10% more work than the least over all of them (bf16), and the fp32
    route has none."""
    cout = 4 * p
    rings = pkb.RINGS if itemsize == 2 else (0,)
    ch, cw, stages = pkb.pick_tile(h, w, cin, p, cout, d, itemsize, proj)
    assert 1 <= ch <= h and 1 <= cw <= w
    assert stages in rings
    assert pkb._smem_bytes(ch, cw, p, d, itemsize, cout, proj, stages) <= pkb.SMEM_LIMIT
    if h * w > 3000:  # the brute force below is for the smaller frames
        return
    work = _tile_work(h, w, cin, p, d, proj, ch, cw, itemsize)
    least = {}
    for st in rings:
        fits = [(c2, w2) for c2 in range(1, h + 1) for w2 in range(1, w + 1)
                if pkb._smem_bytes(c2, w2, p, d, itemsize, cout, proj, st) <= pkb.SMEM_LIMIT]
        if fits:
            least[st] = min(_tile_work(h, w, cin, p, d, proj, c2, w2, itemsize) for c2, w2 in fits)
    assert work == least[stages]
    assert work <= 1.1 * min(least.values())
    assert all(least[st] > 1.1 * min(least.values()) for st in least if st > stages)


@pytest.mark.parametrize("h,w,cin,p,d,proj", MAIN_STAGES + [DC5_LAYER4, (31, 57, 256, 64, 2, False)])
def test_bottleneck_tile_plan_covers_every_pixel_once(h, w, cin, p, d, proj):
    """The kernel's grid (tiles along W fastest) covers each output pixel
    once; each block's x1 halo, clipped to the image, holds every x1 value
    its 3x3 windows read."""
    ch, cw, _ = pkb.pick_tile(h, w, cin, p, 4 * p, d, 2, proj)
    rows, cols = pkb._bands(h, ch), pkb._bands(w, cw)
    assert len(rows) * len(cols) == -(-h // ch) * -(-w // cw)
    hits = np.zeros((h, w), np.int64)
    for r0, nr in rows:
        for c0, nc in cols:
            hits[r0:r0 + nr, c0:c0 + nc] += 1
            ys = {y + dy for y in range(r0, r0 + nr) for dy in (-d, 0, d)} & set(range(h))
            xs = {x + dx for x in range(c0, c0 + nc) for dx in (-d, 0, d)} & set(range(w))
            assert ys <= set(range(max(r0 - d, 0), min(r0 + nr + d, h)))
            assert xs <= set(range(max(c0 - d, 0), min(c0 + nc + d, w)))
    assert (hits == 1).all()


@pytest.mark.parametrize("cin,p,cout,itemsize", [
    (16, 4096, 16384, 4),   # P=4096 in fp32: no 1x1 tile fits
    (12, 64, 256, 2),       # bf16 copies channels in 16-byte chunks: Cin % 8
    (64, 60, 240, 2),       # ... P % 8
    (64, 64, 252, 2),       # ... Cout % 8
])
def test_bottleneck_tile_refuses_what_cannot_fit(cin, p, cout, itemsize):
    with pytest.raises(ValueError, match="shared memory|multiples of 8"):
        pkb.pick_tile(14, 19, cin, p, cout, 2, itemsize, False)


@pytest.mark.parametrize("n,taps,kin,p,bn", [
    (256, 9, 256, 256, 128), (8, 9, 8, 8, 64), (64, 1, 16, 64, 64), (512, 1, 2048, 512, 256),
    (72, 3, 40, 72, 128),
    (1024, 1, 256, 256, 128),   # layer3's w3: the warpgroups split M, so 128 columns per tile
    (512, 9, 512, 512, 256),    # layer4's w2: they split N, 256 columns
    (2048, 1, 1024, 512, 256),  # DC5 layer4.0's projection
])
def test_bottleneck_pack_b_lays_out_the_kernels_tiles(n, taps, kin, p, bn):
    """Weight (channel, tap, k) lands where bottleneck_tc reads it: tile
    (channel chunk, K slice) at (chunk * slices + slice) * BN * BK, inside
    it core matrix (channel / 8, k / 8) of 64 elements, row channel % 8;
    padding is zero. BN follows the block's layout: 64 NT columns when the
    two warpgroups split M (P <= 256), twice that when they split N."""
    assert pkb._tile_n(n, p) == bn
    bk = pkb.BK
    wt = torch.from_numpy(np.random.RandomState(0).randn(n, taps, kin).astype(np.float32))
    packed = pkb._pack_b(wt, bn).contiguous().flatten()
    cpt = -(-kin // bk)
    nk = taps * cpt
    assert packed.numel() == -(-n // bn) * nk * bn * bk
    ch, tap, ci = np.meshgrid(np.arange(n), np.arange(taps), np.arange(kin), indexing="ij")
    chunk, nn = np.divmod(ch, bn)
    kk = ci % bk
    off = ((chunk * nk + tap * cpt + ci // bk) * bn * bk
           + ((nn >> 3) * (bk // 8) + (kk >> 3)) * 64 + (nn & 7) * 8 + (kk & 7))
    np.testing.assert_array_equal(packed.numpy()[off], wt.numpy())
    mask = np.ones(packed.numel(), bool)
    mask[off.ravel()] = False
    assert (packed.numpy()[mask] == 0).all()
    # unpacking inverts it: the weights come back without the padding, and
    # packing them again gives the same tiles, zeros included
    unpacked = pkb._unpack_b(packed, n, taps, kin, bn)
    assert tuple(unpacked.shape) == (n, taps, kin) and torch.equal(unpacked, wt)
    assert torch.equal(pkb._pack_b(unpacked, bn).contiguous().flatten(), packed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,p,proj", [
    (16, 8, True),
    (160, 40, False),    # P and Cout = 4P padded to whole slices and tiles
    (64, 320, True),     # P > 256: the warpgroups split N, 256 columns per tile
])
def test_bottleneck_unpack_gives_back_the_plain_weights(dtype, cin, p, proj):
    """pack holds the block's shape and the kernel's operands; unpack turns
    the operands back into the weights pack cast (biases fp32), bit for bit,
    as the plain version takes them."""
    rng = np.random.RandomState(3)
    packed = pkb.pack(_port_block(make_block(rng, cin, p, proj)), dtype)
    assert (packed.cin, packed.planes, packed.cout, packed.proj) == (cin, p, 4 * p, proj)
    assert packed.operands[0].dtype == dtype
    for name, got, want in zip(pkb.BlockWeights._fields, pkb.unpack(packed), packed.weights):
        if want is None:
            assert got is None, name
        else:
            assert got.dtype == want.dtype and torch.equal(got, want), name


@pytest.mark.parametrize("field,shape,match", [
    ("w3", (8, 48), "identity skip needs Cin == Cout"),
    ("w2", (3, 3, 8, 16), r"w2 is \(3, 3, 8, 16\), expected \(3, 3, 8, 8\)"),
    ("b3", (1, 1, 16), r"b3 is \(1, 1, 16\), expected \(1, 1, 32\)"),
])
def test_bottleneck_pack_refuses_weights_that_do_not_fit_together(field, shape, match):
    """pack validates the block's weights once, whatever their device; each
    launch then checks only x against the shape pack kept."""
    rng = np.random.RandomState(4)
    bw = _port_block(make_block(rng, 32, 8, False))
    bw = bw._replace(**{field: torch.zeros(shape)})
    with pytest.raises(ValueError, match=match):
        pkb.pack(bw, torch.float32)


# --------------------------------------------------------------------------
# K1/K2 wrapper: when the kernels may move tiles by 16-byte copies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dims,itemsize,offset,vec", [
    ((32, 64), 2, 0, True),
    ((32, 64), 2, 1, False),    # contiguous view one element past an aligned address
    ((100, 64), 2, 0, False),   # 200-byte rows
    ((100, 64), 4, 0, True),    # 400-byte rows
    ((70, 64), 4, 0, False),    # 280-byte rows
    ((8, 8), 2, 8, True),       # eight bf16 elements on: aligned again
])
def test_attention_vector_loads_rule(dims, itemsize, offset, vec):
    """16-byte copies only when every head width is a multiple of 16 bytes and
    every tensor starts 16-byte aligned; an offset view is still contiguous
    but takes the element-by-element path."""
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    base = torch.zeros(4 * 64 + 16, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    aligned, view = base[:4 * 64].view(4, 64), base[offset:offset + 4 * 64].view(4, 64)
    assert view.is_contiguous()
    assert pka.vector_loads((aligned, view), dims, itemsize) == vec


def test_build_digest_covers_shared_headers(tmp_path, monkeypatch):
    """An edited source or shared header (csrc/*.cuh) names another library,
    so a stale build is never loaded; the repo's csrc is not touched."""
    import shutil

    from stcat_tpu_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build._lib_path(name) for name in _build.SOURCES}
    header = csrc / "attention_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build._lib_path(name) for name in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    src = csrc / "flash_attention.cu"
    src.write_text(src.read_text() + "\n")
    assert _build._lib_path("flash_attention") != after["flash_attention"]
    assert _build._lib_path("flash_attention_bwd") == after["flash_attention_bwd"]
