"""Fused masked attention: the CUDA kernels ``csrc/flash_attention.cu`` (K1,
forward) and ``csrc/flash_attention_bwd.cu`` (K2, backward), and their plain
PyTorch versions.

``flash_attention(q, k, v, bias)`` keeps the JAX package's interface
(stcat_tpu/kernels/attention.py): q [BH, Sq, Dk], k [BH, Sk, Dk],
v [BH, Sk, Dv] (Dv may differ from Dk), bias [BH, Sk] fp32 with 0 =
attendable and -1e30 = masked, scale 1/sqrt(Dk); returns [BH, Sq, Dv] in q's
dtype. It is a ``torch.autograd.Function``: the forward runs K1 and the
backward K2. Like the TPU kernel it saves q, k, v and bias, not the [Sq, Sk]
weights, and the backward recomputes them.

Dispatch (in the CUDA sources' entry functions):
  * CPU tensors run ``attention_plain`` / ``attention_bwd_plain``;
  * a CUDA tensor launches a kernel or raises (fp32 or bf16, Dk and Dv up to
    128, contiguous):
    - Sq < 8 (the decoders' cross-attention): the row kernels
      ``flash_fwd_rows`` / ``bwd_rows``, either dtype;
    - bf16: the tensor-core kernels ``flash_fwd_mma`` / ``bwd_query_mma`` +
      ``bwd_key_mma`` (mma.sync, head widths zero-padded to 32, 64 or 128);
    - fp32: the CUDA-core kernels ``flash_fwd_tiled`` / ``bwd_query_pass`` +
      ``bwd_key_pass`` (the tensor cores would need TF32).
  Tiles move by 16-byte copies when every head width is a multiple of 16
  bytes and q, k, v (and g) start 16-byte aligned (``vector_loads``), and
  element by element otherwise, so an offset view takes the same kernels.
``LAUNCHES`` and ``BWD_LAUNCHES`` count the calls that launched K1 and K2,
whatever the route.
"""

from __future__ import annotations

import math

import torch

from ..core import trace
from . import _build

MAX_HEAD_DIM = 128
LAUNCHES = trace.Counter("k1.launches")
BWD_LAUNCHES = trace.Counter("k2.launches")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def vector_loads(tensors, dims, itemsize: int) -> bool:
    """Whether the kernels may move tiles by 16-byte copies: every head width
    a multiple of 16 bytes and every tensor 16-byte aligned."""
    return (all(d * itemsize % 16 == 0 for d in dims)
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The same function in plain torch (mirrors ``_xla_attention``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    # products of the compute-dtype inputs, accumulated in fp32
    logits = torch.einsum("bqd,bkd->bqk", (q * scale).float(), k.float())
    logits = logits + bias[:, None, :].float()
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w.to(v.dtype), v).to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, g: torch.Tensor):
    """(dq, dk, dv, dbias) of ``attention_plain`` for the output gradient g,
    in plain torch, step by step as ``_flash_bwd_kernel`` computes them:
    q pre-scaled in its dtype, products of compute-dtype operands with fp32
    accumulation, w rounded to v's dtype for o and dv, d(logits) rounded to
    q's dtype for dq, dk and dbias; dq is unscaled after a rounding, and
    dbias (fp32) passes through k's dtype, as the trailing column of the TPU
    kernel's folded dk does. Keys past Sk do not exist here, so a fully
    masked row has uniform w over the real keys (as in ``_xla_attention``)."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q * scale).to(dt).float()
    logits = torch.einsum("bqd,bkd->bqk", qs, k.float()) + bias[:, None, :].float()
    w = torch.softmax(logits, dim=-1)
    wl = w.to(v.dtype).float()
    gv = g.to(v.dtype).float()
    o = torch.einsum("bqk,bkd->bqd", wl, v.float())
    delta = (g.float() * o).sum(-1, keepdim=True)
    dp = torch.einsum("bqd,bkd->bqk", gv, v.float())
    ds = (w * (dp - delta)).to(dt).float()
    dq = (torch.einsum("bqk,bkd->bqd", ds, k.float()).to(dt).float() * scale).to(dt)
    dk = torch.einsum("bqk,bqd->bkd", ds, qs).to(k.dtype)
    dv = torch.einsum("bqk,bqd->bkd", wl, gv).to(v.dtype)
    dbias = ds.sum(1).to(k.dtype).float()
    return dq, dk, dv, dbias


def _check(q, k, v, bias) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda and bias.is_cuda):
        raise ValueError("flash_attention: q, k, v and bias must all be CUDA tensors")
    if len({q.device, k.device, v.device, bias.device}) != 1:
        raise ValueError("flash_attention: tensors on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v must share fp32 or bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if bias.dtype != torch.float32:
        raise ValueError(f"flash_attention: bias must be fp32, got {bias.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or bias.dim() != 2:
        raise ValueError("flash_attention: expected q/k/v [BH, S, D] and bias [BH, Sk]")
    bh, _, dk = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, dk) or v.shape[:2] != (bh, sk) or bias.shape != (bh, sk):
        raise ValueError(f"flash_attention: shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} bias{tuple(bias.shape)}")
    if dk > MAX_HEAD_DIM or v.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims up to {MAX_HEAD_DIM}, got "
                         f"Dk={dk} Dv={v.shape[2]}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")


def _check_grad(q, v, g) -> None:
    if not g.is_cuda or g.device != q.device:
        raise ValueError("flash_attention backward: g must be on q's CUDA device")
    if g.dtype != q.dtype:
        raise ValueError(f"flash_attention backward: g must be {q.dtype}, got {g.dtype}")
    expect = (q.shape[0], q.shape[1], v.shape[2])
    if tuple(g.shape) != expect or not g.is_contiguous():
        raise ValueError(f"flash_attention backward: g must be a contiguous {expect}, got "
                         f"{tuple(g.shape)}")


def _launch(q, k, v, bias) -> torch.Tensor:
    bh, sq, dk = q.shape
    sk, dv = v.shape[1], v.shape[2]
    out = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    vec = vector_loads((q, k, v), (dk, dv), q.element_size())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.load("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        bh, sq, sk, dk, dv, _DTYPES[q.dtype], int(vec), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out


def _launch_bwd(q, k, v, bias, g):
    """K2: (dq, dk, dv, dbias) on the card."""
    bh, sq, dk = q.shape
    sk, dv = v.shape[1], v.shape[2]
    dq, dkk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty((bh, sk), dtype=torch.float32, device=q.device)
    # row statistics (m, l, delta) of the two-pass path (the Sq < 8 row
    # kernel leaves them unused)
    stats = torch.empty((3, bh * sq), dtype=torch.float32, device=q.device)
    vec = vector_loads((q, k, v, g), (dk, dv), q.element_size())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.load("flash_attention_bwd").flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dkk.data_ptr(), dvv.data_ptr(), dbias.data_ptr(), stats.data_ptr(),
        bh, sq, sk, dk, dv, _DTYPES[q.dtype], int(vec), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: CUDA error {err}")
    BWD_LAUNCHES.add()
    return dq, dkk, dvv, dbias


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        if q.device.type == "cpu":
            return attention_plain(q, k, v, bias)
        _check(q, k, v, bias)
        return _launch(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_bwd(q, k, v, bias, g.contiguous())
        return dq, dk, dv, (dbias if ctx.needs_input_grad[3] else None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Masked scaled-dot-product attention, differentiable; the kernels on
    CUDA tensors."""
    return _FlashAttention.apply(q, k, v, bias)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, g: torch.Tensor):
    """(dq, dk, dv, dbias) for the output gradient g: K2 on CUDA tensors,
    ``attention_bwd_plain`` on CPU tensors."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, bias, g)
    _check(q, k, v, bias)
    _check_grad(q, v, g)
    return _launch_bwd(q, k, v, bias, g)
