"""Fused stride-1 ResNet bottleneck: the CUDA kernel ``csrc/bottleneck.cu`` and
its plain PyTorch version.

``fused_bottleneck(x, weights, dilation)`` keeps the JAX package's interface
(stcat_tpu/kernels/conv.py): x [N, H, W, Cin] NHWC in the compute dtype,
``BlockWeights`` with FrozenBN already folded in (w1 [Cin, P], w2 [3, 3, P, P]
HWIO, w3 [P, Cout], wd [Cin, Cout] or None, fp32 biases [1, 1, C]), dilation 1
or 2; returns [N, H, W, Cout] in x's dtype. On CUDA tensors it launches the
kernel or raises; on CPU tensors it runs ``bottleneck_plain``.

x may be a channels-last view of an NCHW tensor (``permute(0, 2, 3, 1)`` of
a ``torch.channels_last`` tensor is contiguous), so the backbone hands its
activations over without a copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

# shared memory one thread block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
LAUNCHES = _build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class BlockWeights(NamedTuple):
    """Folded (BN absorbed) bottleneck weights; biases are [1, 1, C] fp32."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    wd: Optional[torch.Tensor]
    bd: Optional[torch.Tensor]


def bottleneck_plain(x: torch.Tensor, p: BlockWeights, dilation: int = 1) -> torch.Tensor:
    """The same function in plain torch (mirrors ``bottleneck_reference``):
    inputs and weights rounded to x's dtype, products accumulated in fp32
    (JAX's ``preferred_element_type=float32``), bias-add and ReLU in fp32,
    x1/y2 rounded to x's dtype."""
    dt = x.dtype
    xc = x.permute(0, 3, 1, 2)

    def conv1x1(a, wmat, b):
        w = wmat.t().to(dt).float()[:, :, None, None]
        return F.conv2d(a.float(), w) + b.reshape(1, -1, 1, 1).float()

    x1 = torch.relu(conv1x1(xc, p.w1, p.b1)).to(dt)
    w2 = p.w2.permute(3, 2, 0, 1).to(dt).float()
    y2 = F.conv2d(x1.float(), w2, padding=dilation, dilation=dilation)
    y2 = torch.relu(y2 + p.b2.reshape(1, -1, 1, 1).float()).to(dt)
    y3 = conv1x1(y2, p.w3, p.b3)
    res = conv1x1(xc, p.wd, p.bd) if p.wd is not None else xc.float()
    return torch.relu(y3 + res).to(dt).permute(0, 2, 3, 1)


def _smem_bytes(ch: int, cw: int, p: int, d: int, itemsize: int) -> int:
    """Host copy of ``bottleneck_smem_bytes`` in csrc/bottleneck.cu."""
    stage = 4 * (16 * 68 + 16 * 64)
    return stage + ((ch + 2 * d) * (cw + 2 * d) + ch * cw) * p * itemsize


@functools.lru_cache(maxsize=64)
def pick_tile(h: int, w: int, p: int, d: int, itemsize: int) -> Tuple[int, int]:
    """Output tile (rows, cols) per thread block. x1 (with its d-wide halo)
    and y2 must fit shared memory; among the tiles that fit, the one that
    computes the fewest x1 positions over the whole frame (halo and ragged
    last tiles included), then the largest."""
    best = None
    for ch in range(1, h + 1):
        for cw in range(1, w + 1):
            if _smem_bytes(ch, cw, p, d, itemsize) > SMEM_LIMIT:
                break
            work = -(-h // ch) * -(-w // cw) * (ch + 2 * d) * (cw + 2 * d)
            key = (work, -ch * cw)
            if best is None or key < best[0]:
                best = (key, (ch, cw))
    if best is None:
        raise ValueError(
            f"fused_bottleneck: a 1x1 tile with P={p}, dilation={d} in {itemsize}-byte "
            f"elements needs {_smem_bytes(1, 1, p, d, itemsize)} B of shared memory, over "
            f"the {SMEM_LIMIT} B a block may use"
        )
    return best[1]


def _check(x: torch.Tensor, p: BlockWeights, dilation: int) -> None:
    if not x.is_cuda:
        raise ValueError("fused_bottleneck: x must be a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_bottleneck: x must be fp32 or bf16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_bottleneck: x must be a contiguous NHWC [N, H, W, Cin]")
    if dilation not in (1, 2):
        raise ValueError(f"fused_bottleneck: dilation 1 or 2, got {dilation}")
    cin = x.shape[3]
    planes, cout = p.w1.shape[1], p.w3.shape[1]
    shapes = {"w1": (cin, planes), "w2": (3, 3, planes, planes), "w3": (planes, cout),
              "b1": (1, 1, planes), "b2": (1, 1, planes), "b3": (1, 1, cout)}
    if p.wd is not None:
        shapes.update(wd=(cin, cout), bd=(1, 1, cout))
    elif cin != cout:
        raise ValueError(f"fused_bottleneck: identity skip needs Cin == Cout, got {cin}, {cout}")
    for name, shape in shapes.items():
        t = getattr(p, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_bottleneck: {name} is {tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"fused_bottleneck: {name} is not on {x.device}")
    if x.shape[0] > 65535:
        raise ValueError("fused_bottleneck: at most 65535 frames per launch")


def _launch(x: torch.Tensor, p: BlockWeights, dilation: int) -> torch.Tensor:
    n, h, w, cin = x.shape
    planes, cout = p.w1.shape[1], p.w3.shape[1]
    dt = x.dtype
    ch, cw = pick_tile(h, w, planes, dilation, x.element_size())
    # weights in the compute dtype, biases fp32, all contiguous
    wts = [p.w1.to(dt).contiguous(), p.b1.float().contiguous(),
           p.w2.to(dt).contiguous(), p.b2.float().contiguous(),
           p.w3.to(dt).contiguous(), p.b3.float().contiguous()]
    if p.wd is not None:
        wts += [p.wd.to(dt).contiguous(), p.bd.float().contiguous()]
    ptrs = [t.data_ptr() for t in wts] + ([] if p.wd is not None else [None, None])
    out = torch.empty((n, h, w, cout), dtype=dt, device=x.device)

    lib = _build.load("bottleneck")
    fn = lib.bottleneck_fwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), *ptrs, out.data_ptr(), n, h, w, cin, planes, cout,
             dilation, ch, cw, _DTYPES[dt], stream)
    if err != 0:
        raise RuntimeError(f"fused_bottleneck kernel launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out


def fused_bottleneck(x: torch.Tensor, p: BlockWeights, dilation: int = 1) -> torch.Tensor:
    """Stride-1 bottleneck block; the kernel on CUDA tensors."""
    if x.device.type == "cpu":
        return bottleneck_plain(x, p, dilation)
    _check(x, p, dilation)
    return _launch(x, p, dilation)
