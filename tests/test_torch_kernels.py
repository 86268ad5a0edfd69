"""Port kernels: the plain PyTorch versions against the JAX package's kernels.

``attention_plain`` is held against ``_xla_attention`` and against the Pallas
``_flash_fwd`` run in interpret mode; ``bottleneck_plain`` against
``bottleneck_reference`` and the interpreted ``_fused_fwd``. Inputs are numpy
arrays from a seed handed to both. Tolerance: fp32, atol 2e-5, as in
tests/test_kernels.py (summation order only).

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


def test_bottleneck_wrapper_on_cpu_runs_plain_without_launch():
    rng = np.random.RandomState(2)
    bw = _port_block(make_block(rng, 16, 8, True))
    x = torch.from_numpy(rng.randn(1, 6, 5, 16).astype(np.float32))
    out = pkb.fused_bottleneck(x, bw, 1)
    assert pkb.LAUNCHES.count == 0
    torch.testing.assert_close(out, pkb.bottleneck_plain(x, bw, 1), rtol=0, atol=0)


@pytest.mark.parametrize("h,w,p,d,itemsize", [
    (112, 152, 64, 1, 2),   # layer1 bf16
    (56, 76, 128, 1, 2),    # layer2 bf16
    (28, 38, 256, 1, 2),    # layer3 bf16
    (14, 19, 512, 1, 2),    # layer4 bf16
    (14, 19, 512, 1, 4),    # layer4 fp32
    (28, 38, 512, 2, 4),    # DC5 layer4 fp32: not even one whole row fits
])
def test_bottleneck_tile_fits_shared_memory(h, w, p, d, itemsize):
    ch, cw = pkb.pick_tile(h, w, p, d, itemsize)
    assert 1 <= ch <= h and 1 <= cw <= w
    assert pkb._smem_bytes(ch, cw, p, d, itemsize) <= pkb.SMEM_LIMIT
    # no tile that fits computes fewer x1 positions over the frame
    work = lambda c, v: -(-h // c) * -(-w // v) * (c + 2 * d) * (v + 2 * d)
    assert all(work(c2, w2) >= work(ch, cw) for c2 in range(1, h + 1) for w2 in range(1, w + 1)
               if pkb._smem_bytes(c2, w2, p, d, itemsize) <= pkb.SMEM_LIMIT)


def test_bottleneck_tile_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        pkb.pick_tile(14, 19, 4096, 2, 4)  # P=4096 in fp32: no 1x1 tile fits
