"""Fused masked attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain PyTorch version.

``flash_attention(q, k, v, bias)`` keeps the JAX package's interface
(stcat_tpu/kernels/attention.py): q [BH, Sq, Dk], k [BH, Sk, Dk],
v [BH, Sk, Dv] (Dv may differ from Dk), bias [BH, Sk] fp32 with 0 =
attendable and -1e30 = masked, scale 1/sqrt(Dk); returns [BH, Sq, Dv] in q's
dtype. On CUDA tensors it launches the kernel (fp32 or bf16, Dk and Dv up to
128) or raises; on CPU tensors it runs ``attention_plain``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

MAX_HEAD_DIM = 128
LAUNCHES = _build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The same function in plain torch (mirrors ``_xla_attention``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    # products of the compute-dtype inputs, accumulated in fp32
    logits = torch.einsum("bqd,bkd->bqk", (q * scale).float(), k.float())
    logits = logits + bias[:, None, :].float()
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w.to(v.dtype), v).to(q.dtype)


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


def _launch(q, k, v, bias) -> torch.Tensor:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bh, sq, dk = q.shape
    sk, dv = v.shape[1], v.shape[2]
    out = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
             bh, sq, sk, dk, dv, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Masked scaled-dot-product attention; the kernel on CUDA tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias)
    _check(q, k, v, bias)
    return _launch(q, k, v, bias)
