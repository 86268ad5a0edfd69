"""Fused stride-1 ResNet bottleneck: the CUDA kernel ``csrc/bottleneck.cu`` and
its plain PyTorch version.

``fused_bottleneck(x, weights, dilation)`` keeps the JAX package's interface
(stcat_tpu/kernels/conv.py): x [N, H, W, Cin] NHWC in the compute dtype,
``BlockWeights`` with FrozenBN already folded in (w1 [Cin, P], w2 [3, 3, P, P]
HWIO, w3 [P, Cout], wd [Cin, Cout] or None, fp32 biases [1, 1, C]), dilation 1
or 2; returns [N, H, W, Cout] in x's dtype. It is a
``torch.autograd.Function`` over x and the eight weight tensors: the forward
launches the kernel on CUDA tensors (or raises) and runs ``bottleneck_plain``
on CPU tensors. On the card bf16 takes the tensor-core kernel
(``bottleneck_tc``) and fp32 the CUDA-core one (``bottleneck_fwd``); both
count in ``LAUNCHES`` (``k3.launches``), those at dilation 2 in ``DILATED``
too (``k3.dilated``). The backward, like the JAX package's ``_vjp_bwd``,
re-runs ``bottleneck_plain`` under autograd on the saved x and weights and
takes its gradients (the TPU kernel has no backward kernel either), with
cuDNN's TF32 off whatever the caller set. Only x and the folded weights are
saved. A forward without gradient may instead hand over ``Packed`` weights,
which ``pack`` validates, casts and lays out once (the backbone keeps them
per weight version): it then checks only x and launches with no cast, zero
fill or copy of its own. On the card a ``Packed`` block holds the kernel's
operands and nothing else; ``unpack`` gives the plain weights back.

x may be a channels-last view of an NCHW tensor (``permute(0, 2, 3, 1)`` of
a ``torch.channels_last`` tensor is contiguous), so the backbone hands its
activations over without a copy.

``bottleneck_tc`` is one launch per block call, warp-specialised (the design
note in ``csrc/bottleneck.cu``): two consumer warpgroups (warps 0-7) run
every GEMM on wgmma with both operands in shared memory, wait for each
slice's group and hand its ring stage straight back on its empty mbarrier
while the next slices' copies are in flight; a producer warpgroup (warps
8-11) fills the ring, lane 0 of warp 8
issuing each slice's packed weight tile as one bulk copy and warps 9-11
putting its A tile (x rows by cp.async, the 3x3's shifted x1 windows by
shared-memory copies), all completing on the stage's full mbarrier. Inside
the K loop there is no block-wide barrier; the consumers meet on a barrier
of their own twice per subtile, where y2 changes hands.
The host side here chooses per shape what the kernel takes as parameters:
the tile and the ring depth (``pick_tile``: least work with halo recompute
and rows rounded up to BM counted, then the deepest ring within 10% of it),
the warpgroups' split (along M, so that a weight slice serves 128 pixels,
where P <= 256; along N at P = 512) and the wgmma width by each GEMM's N
(``_layout``, which ``pack`` follows: ``_tile_n`` columns per packed B tile,
BK = 32 deep). What bounds each regime: where P <= 256, the producers'
handoff per 32-deep slice and the epilogues; at P = 512, the weight slices'
traffic through L2 (4-6 TB/s), which a deeper ring or a better K loop does
not remove.
"""

from __future__ import annotations

import contextlib
import functools
from collections import Counter
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import trace
from . import _build

# shared memory one thread block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
LAUNCHES = trace.Counter("k3.launches")
# the launches at dilation 2 (DC5's layer4 after its first block), among LAUNCHES
DILATED = trace.Counter("k3.dilated")

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


# bf16 route (csrc/bottleneck.cu, namespace tc): ring slices of BK rows of
# K, 3 to MAX_STAGES of them; every x1 pixel row in shared memory padded by
# APAD elements; HEAD_BYTES of mbarriers before the ring
BK, APAD, HEAD_BYTES, MAX_STAGES = 32, 8, 128, 6
RINGS = tuple(range(MAX_STAGES, 2, -1))


def _layout(n: int, p: int) -> Tuple[int, int]:
    """(warpgroups along M, m64n64 tiles per warpgroup) of a GEMM whose N is
    n wide in a block of P = p: the warpgroups split M when p <= 256."""
    return (2 if p <= 256 else 1), (1 if n <= 64 else 2)


def _tile_n(n: int, p: int) -> int:
    """Columns of B per GEMM tile of that GEMM."""
    wgm, nt = _layout(n, p)
    return 64 * nt * (2 // wgm)


def _pack_b(wt: torch.Tensor, bn: int) -> torch.Tensor:
    """K-major weights [N, taps, kin] -> the tensor-core route's B tiles: per
    chunk of bn output channels and per BK-deep slice of K (each tap's kin
    zero-padded to whole slices), one contiguous tile in core-matrix order
    (8 channels x 8 K values per 128 bytes, the next 8 K, then the next 8
    channels); channels past N are zero."""
    n, taps, kin = wt.shape
    cpt, n_pad = -(-kin // BK), -(-n // bn) * bn
    w = wt.new_zeros(n_pad, taps, cpt * BK)
    w[:n, :, :kin] = wt
    w = w.reshape(n_pad // bn, bn // 8, 8, taps * cpt, BK // 8, 8)
    return w.permute(0, 3, 1, 4, 2, 5)


def _unpack_b(packed: torch.Tensor, n: int, taps: int, kin: int, bn: int) -> torch.Tensor:
    """The inverse of ``_pack_b``: B tiles -> K-major weights [n, taps, kin],
    the zero padding dropped."""
    cpt, n_pad = -(-kin // BK), -(-n // bn) * bn
    w = packed.reshape(n_pad // bn, taps * cpt, bn // 8, BK // 8, 8, 8).permute(0, 2, 4, 1, 3, 5)
    return w.reshape(n_pad, taps, cpt * BK)[:n, :, :kin]


def _smem_bytes(ch: int, cw: int, p: int, d: int, itemsize: int, cout: int, proj: bool,
                stages: int) -> int:
    """Host copy of ``bottleneck_smem_bytes`` in csrc/bottleneck.cu."""
    if itemsize == 4:  # fp32 route: K-slice staging, x1 with halo, y2 of the tile
        return 4 * (16 * 68 + 16 * 64) + ((ch + 2 * d) * (cw + 2 * d) + ch * cw) * p * 4

    def a_bytes(wgm):
        return 64 * wgm * BK * 2

    def b_bytes(wgm, nt):
        return BK * 64 * nt * (2 // wgm) * 2

    (wp, tp), (wc, tc) = _layout(p, p), _layout(cout, p)
    stage = max(a_bytes(wp) + b_bytes(wp, tp), b_bytes(wc, tc) + (a_bytes(wc) if proj else 0))
    x1 = (ch + 2 * d) * (cw + 2 * d) * (p + APAD) * 2
    y2 = 64 * wp * -(-p // BK) * BK * 2
    return HEAD_BYTES + stages * stage + x1 + y2


def _bands(n: int, c: int) -> List[Tuple[int, int]]:
    """(start, size) of the tiles along one axis, in the kernel's block order."""
    return [(s, min(c, n - s)) for s in range(0, n, c)]


def _best_tile(h, w, cin, p, cout, d, itemsize, proj, stages):
    """(work, (rows, cols)) of the tile that fits shared memory with the least
    GEMM work over the frame, then the largest; None if none fits. Work
    counts x1's halo recompute and, on the bf16 route, rows rounded up to
    the GEMMs' BM (64 rows per warpgroup along M: phase 1 over the haloed
    tile, phases 2-3 over the tile)."""
    g = 64 * _layout(p, p)[0] if itemsize == 2 else 1
    k1, k23 = cin * p, 9 * p * p + p * cout + (cin * cout if proj else 0)
    best = None
    for ch in range(1, h + 1):
        rows = Counter(size for _, size in _bands(h, ch))
        for cw in range(1, w + 1):
            if _smem_bytes(ch, cw, p, d, itemsize, cout, proj, stages) > SMEM_LIMIT:
                break
            cols = Counter(size for _, size in _bands(w, cw))
            work = sum(nr * nc * (-(-(r + 2 * d) * (c + 2 * d) // g) * k1 + -(-r * c // g) * k23)
                       for r, nr in rows.items() for c, nc in cols.items())
            if best is None or (work, -ch * cw) < (best[0], -best[1][0] * best[1][1]):
                best = (work, (ch, cw))
    return best


@functools.lru_cache(maxsize=64)
def pick_tile(h: int, w: int, cin: int, p: int, cout: int, d: int, itemsize: int,
              proj: bool) -> Tuple[int, int, int]:
    """(rows, cols) of the output tile per thread block and the depth of the
    bf16 route's ring (0 on the fp32 route). A deeper ring lets the producers
    keep more slices in flight but leaves less shared memory for x1:
    the deepest of ``RINGS`` is taken whose best tile does at most 10% more
    work than the least over all of them."""
    if itemsize == 2 and (cin % 8 or p % 8 or cout % 8):
        # the tensor-core route copies channels in 16-byte chunks (8 bf16)
        raise ValueError(f"fused_bottleneck: bf16 needs Cin, P and Cout multiples of 8, "
                         f"got {cin}, {p}, {cout}")
    rings = RINGS if itemsize == 2 else (0,)
    found = {st: best for st in rings
             if (best := _best_tile(h, w, cin, p, cout, d, itemsize, proj, st)) is not None}
    if not found:
        raise ValueError(
            f"fused_bottleneck: a 1x1 tile with P={p}, dilation={d} in {itemsize}-byte "
            f"elements needs {_smem_bytes(1, 1, p, d, itemsize, cout, proj, rings[-1])} B of "
            f"shared memory, over the {SMEM_LIMIT} B a block may use"
        )
    least = min(work for work, _ in found.values())
    st = next(st for st, (work, _) in found.items() if work <= 1.1 * least)
    return (*found[st][1], st)


class Packed(NamedTuple):
    """A block's folded weights made ready once for one compute dtype and
    device (``pack``): the kernel's operands in its argument order,
    contiguous (bf16: packed B tiles), and the block's shape. On the CPU,
    where the plain version runs, also ``weights`` in that dtype with fp32
    biases; on the card the operands are the only copy (``unpack`` gives
    the plain weights back)."""

    operands: Tuple[Optional[torch.Tensor], ...]
    cin: int
    planes: int
    cout: int
    weights: Optional[BlockWeights]

    @property
    def proj(self) -> bool:
        return self.operands[6] is not None


def _check_weights(p: BlockWeights) -> None:
    cin, planes, cout = p.w1.shape[0], p.w1.shape[1], p.w3.shape[1]
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
        if t.device != p.w1.device:
            raise ValueError(f"fused_bottleneck: {name} is not on {p.w1.device}")


def pack(p: BlockWeights, dtype: torch.dtype) -> Packed:
    """``p`` validated, cast to ``dtype`` (biases fp32) and laid out as the
    kernel reads it."""
    _check_weights(p)
    w = BlockWeights(*[None if t is None else t.to(dtype if i % 2 == 0 else torch.float32)
                       for i, t in enumerate(p)])
    cin, planes, cout = w.w1.shape[0], w.w1.shape[1], w.w3.shape[1]
    if dtype == torch.bfloat16:
        bn_p, bn_c = _tile_n(planes, planes), _tile_n(cout, planes)
        w1 = _pack_b(w.w1.t()[:, None], bn_p)
        w2 = _pack_b(w.w2.permute(3, 0, 1, 2).reshape(planes, 9, planes), bn_p)
        w3 = _pack_b(w.w3.t()[:, None], bn_c)
        wd = None if w.wd is None else _pack_b(w.wd.t()[:, None], bn_c)
    else:
        w1, w2, w3, wd = w.w1, w.w2, w.w3, w.wd
    operands = tuple(None if t is None else t.contiguous()
                     for t in (w1, w.b1, w2, w.b2, w3, w.b3, wd, w.bd))
    return Packed(operands, cin, planes, cout, None if w.w1.is_cuda else w)


def unpack(p: Packed) -> BlockWeights:
    """The plain weights of a ``Packed`` block, from its operands: the
    inverse of ``pack``'s layout, padding dropped, in the packed dtype with
    fp32 biases."""
    w1, b1, w2, b2, w3, b3, wd, bd = p.operands
    if w1.dtype == torch.bfloat16:
        bn_p, bn_c = _tile_n(p.planes, p.planes), _tile_n(p.cout, p.planes)
        w1 = _unpack_b(w1, p.planes, 1, p.cin, bn_p)[:, 0].t()
        w2 = _unpack_b(w2, p.planes, 9, p.planes, bn_p).reshape(p.planes, 3, 3, p.planes)
        w2 = w2.permute(1, 2, 3, 0)
        w3 = _unpack_b(w3, p.cout, 1, p.planes, bn_c)[:, 0].t()
        wd = None if wd is None else _unpack_b(wd, p.cout, 1, p.cin, bn_c)[:, 0].t()
    return BlockWeights(w1, b1, w2, b2, w3, b3, wd, bd)


def _check(x: torch.Tensor, p: Packed, dilation: int) -> None:
    if not x.is_cuda:
        raise ValueError("fused_bottleneck: x must be a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_bottleneck: x must be fp32 or bf16, got {x.dtype}")
    if x.dtype != p.operands[0].dtype:
        raise ValueError(f"fused_bottleneck: x is {x.dtype}, the weights were packed for "
                         f"{p.operands[0].dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_bottleneck: x must be a contiguous NHWC [N, H, W, Cin]")
    if x.shape[3] != p.cin:
        raise ValueError(f"fused_bottleneck: x has {x.shape[3]} channels, the weights take {p.cin}")
    if x.device != p.operands[0].device:
        raise ValueError(f"fused_bottleneck: the weights are not on {x.device}")
    if dilation not in (1, 2):
        raise ValueError(f"fused_bottleneck: dilation 1 or 2, got {dilation}")
    if x.shape[0] > 65535:
        raise ValueError("fused_bottleneck: at most 65535 frames per launch")
    if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
        raise ValueError("fused_bottleneck: x must start on a 16-byte boundary")


def _launch(x: torch.Tensor, p: Packed, dilation: int) -> torch.Tensor:
    n, h, w, cin = x.shape
    ch, cw, stages = pick_tile(h, w, cin, p.planes, p.cout, dilation, x.element_size(), p.proj)
    ptrs = [None if t is None else t.data_ptr() for t in p.operands]
    out = torch.empty((n, h, w, p.cout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.load("bottleneck").bottleneck_fwd_launch(
        x.data_ptr(), *ptrs, out.data_ptr(), n, h, w, cin, p.planes, p.cout, dilation, ch, cw,
        stages, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_bottleneck kernel launch failed: CUDA error {err}")
    LAUNCHES.add()
    if dilation == 2:
        DILATED.add()
    return out


def _forward(x: torch.Tensor, p: Packed, dilation: int) -> torch.Tensor:
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if x.device.type == "cpu":
        return bottleneck_plain(x, p.weights, dilation)
    _check(x, p, dilation)
    return _launch(x, p, dilation)


@contextlib.contextmanager
def _cudnn_fp32():
    """cuDNN's TF32 switched off for the block, every other cuDNN flag left
    as the caller set it."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class _FusedBottleneck(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dilation, *weights):
        ctx.dilation = dilation
        ctx.save_for_backward(x, *weights)
        return _forward(x, pack(BlockWeights(*weights), x.dtype), dilation)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[2:]
        # fp32 convolutions whatever the caller's TF32 flag: cuDNN's TF32
        # convolutions move the bf16 gradients by 1e-3 to 1.6e-2 (PERF.md)
        with torch.enable_grad(), _cudnn_fp32():
            inputs = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(saved, needs)]
            out = bottleneck_plain(inputs[0], BlockWeights(*inputs[1:]), ctx.dilation)
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        dx, *dw = [next(grads) if t is not None and t.requires_grad else None for t in inputs]
        return (dx, None, *dw)


def fused_bottleneck(x: torch.Tensor, p: BlockWeights | Packed, dilation: int = 1) -> torch.Tensor:
    """Stride-1 bottleneck block; the kernel on CUDA tensors. With
    ``BlockWeights`` it is differentiable and packs the weights on every
    call; with ``Packed`` weights (``pack``, made once) it serves a forward
    without gradient and launches with them as they are."""
    if not isinstance(p, Packed):
        return _FusedBottleneck.apply(x, dilation, *p)
    if torch.is_grad_enabled():
        raise ValueError("fused_bottleneck: Packed weights serve a forward without gradient")
    return _forward(x, p, dilation)
