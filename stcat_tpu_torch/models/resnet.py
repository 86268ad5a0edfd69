"""ResNet-50/101 vision backbone with frozen batch-norm.

Parameter names follow torchvision (conv1, bn1, layer1.0.conv1, ...,
downsample.0/1) so the reference STCAT state_dict lays over it. Activations
are NCHW tensors in ``torch.channels_last`` memory, i.e. NHWC in memory like
the JAX package, so the fused-bottleneck kernel takes them as NHWC views
without a copy.

DC5 (``dc5``, MODEL.VISION_BACKBONE.DILATION) builds layer4 as torchvision's
``replace_stride_with_dilation=[False, False, True]`` does, as DETR and
STCAT take it: stride 1 throughout, layer4.0's 3x3 at dilation 1 beside a
stride-1 projection, the later 3x3s at dilation and padding 2. The body's
stride is then 16, not 32, and every layer4 block is a stride-1 block.

FrozenBN keeps torchvision's four buffers and applies
scale = weight * rsqrt(running_var + 1e-5), bias = bias - running_mean * scale
in x's dtype. With gradients on, stride-1 FrozenBN blocks of the stages in
TPU.CONV_STAGES go through the fused kernel when TPU.CONV_IMPL is "pallas",
with FrozenBN folded into the conv weights as ``stcat_tpu``'s
``Bottleneck._fused`` does; the stem, the stride-2 first blocks and the
GroupNorm variant use ``F.conv2d``.

A bf16 FrozenBN forward without gradient (``torch.no_grad``,
``torch.inference_mode``, training's frozen prefix) folds FrozenBN into
every convolution, whatever TPU.CONV_IMPL says: each stride-1 block is one
fused-kernel launch, and each conv of the stem and the stride-2 blocks
carries its folded bias, on the card with the ReLU and the residual add in
cuDNN's epilogue (``torch.cudnn_convolution_relu``, ``_add_relu``; on the
CPU in place after ``F.conv2d``). The folded weights are made once per
weight version: each module keeps them keyed on the device and on the
``data_ptr`` and ``_version`` of its conv weights and FrozenBN buffers, so
``load_state_dict``, an optimizer step or an EMA copy rebuilds them on the
next such forward (``refold``: the span ``backbone.fold``, one count in
``k3.folds`` per forward that rebuilt any). fp32 forwards keep their
rounding; K3 has no backward kernel, so forwards with gradient keep their
route.

Training: the stem and the first ``frozen_stages`` stages (1, or 4 when the
whole body is frozen) run without gradients, where the JAX package puts its
stop_gradient, so their backward never runs. With ``remat_blocks`` the
unfused blocks of ``remat_stages`` past the frozen prefix are recomputed in
the backward (``torch.utils.checkpoint``); a fused block is not, because
its autograd Function already keeps only its input and recomputes the block
in its backward (remat there would recompute it twice).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..core import trace
from ..kernels import bottleneck as kbottle

BN_EPS = 1e-5
FOLDS = trace.Counter("k3.folds")


class FrozenBatchNorm2d(nn.Module):
    """Per-channel affine from fixed batch statistics (never trained).

    A fresh module is the identity: weight 1, bias 0, mean 0 and
    running_var = 1 - eps, so that weight * rsqrt(var + eps) is 1.
    """

    def __init__(self, num_features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.full((num_features,), 1.0 - BN_EPS))

    def consts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Folded (scale, bias), fp32."""
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + BN_EPS)
        return scale, self.bias.float() - self.running_mean.float() * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, bias = self.consts()
        return x * scale.to(x.dtype)[None, :, None, None] + bias.to(x.dtype)[None, :, None, None]


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32 groups, eps 1e-5) with statistics in fp32, output in x's dtype."""

    def __init__(self, num_features: int):
        super().__init__(32, num_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


def _norm(kind: str, features: int) -> nn.Module:
    return GroupNorm32(features) if kind == "gn" else FrozenBatchNorm2d(features)


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding, conv.dilation)


def _fold_conv(conv: nn.Conv2d, bn: FrozenBatchNorm2d, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight in ``dtype``, fp32 bias) of ``bn(conv(x))`` as one
    convolution; the weight in channels-last memory, as cuDNN takes it
    beside a channels-last input."""
    scale, bias = bn.consts()
    w = conv.weight.float() * scale[:, None, None, None]
    return w.to(dtype).contiguous(memory_format=torch.channels_last), bias


def _conv_relu(x: torch.Tensor, conv: nn.Conv2d, w: torch.Tensor, b: torch.Tensor,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(conv(x, w) + b [+ z]) with ``conv``'s geometry: on the card one
    cuDNN call, bias, residual and ReLU in its epilogue; elsewhere
    ``F.conv2d`` with the bias, then the add and ReLU in place."""
    geometry = (conv.stride, conv.padding, conv.dilation, 1)
    if x.is_cuda:
        if z is None:
            return torch.cudnn_convolution_relu(x, w, b, *geometry)
        return torch.cudnn_convolution_add_relu(x, w, z, 1, b, *geometry)
    y = F.conv2d(x, w, b, *geometry)
    return (y if z is None else y.add_(z)).relu_()


class _Folds:
    """A module whose FrozenBN a forward without gradient folds into its
    convolutions: ``_conv_bns`` are its (conv, FrozenBN) pairs,
    ``_build_fold`` folds them, ``_fold`` holds (key, folded weights)."""

    _fold: Tuple = (None, None)

    @property
    def folds(self) -> bool:
        """Whether this forward folds FrozenBN (bf16, no gradient)."""
        return (self.norm == "frozenbn" and self.dtype == torch.bfloat16
                and not torch.is_grad_enabled())

    def _fold_key(self, device: torch.device) -> Tuple:
        return (device,) + tuple(
            (t.data_ptr(), t._version) for conv, bn in self._conv_bns()
            for t in (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var))

    def _folded(self, device: torch.device):
        refold([self], device)
        return self._fold[1]


def refold(modules: Iterable[_Folds], device: torch.device) -> None:
    """Rebuild the folded weights of each module whose entry is missing or
    was built from other tensors, all in one ``backbone.fold`` span counted
    once in ``k3.folds``. The entries are made outside inference mode, so a
    later ``no_grad`` forward can use them too."""
    stale = [(m, key) for m in modules if (key := m._fold_key(device)) != m._fold[0]]
    if not stale:
        return
    with trace.span("backbone.fold", modules=len(stale)), torch.inference_mode(False), \
            torch.no_grad():
        for m, key in stale:
            m._fold = (key, m._build_fold())
    FOLDS.add()


class Bottleneck(_Folds, nn.Module):
    """torchvision bottleneck: 1x1 -> 3x3(stride, dilation) -> 1x1(x4) + skip."""

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, dtype=torch.float32, conv_impl: str = "xla",
                 norm: str = "frozenbn"):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.dtype, self.conv_impl, self.norm = dtype, conv_impl, norm
        cout = planes * 4
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = _norm(norm, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = _norm(norm, planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = _norm(norm, cout)
        self.downsample = (
            nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False), _norm(norm, cout))
            if downsample else None
        )

    @property
    def fused(self) -> bool:
        return self.stride == 1 and self.norm == "frozenbn" and self.conv_impl == "pallas"

    def folded_weights(self) -> kbottle.BlockWeights:
        """FrozenBN folded into the conv weights, in the kernel's layout."""
        s1, c1 = self.bn1.consts()
        s2, c2 = self.bn2.consts()
        s3, c3 = self.bn3.consts()
        wd = bd = None
        if self.downsample is not None:
            sd, cd = self.downsample[1].consts()
            wd = self.downsample[0].weight[:, :, 0, 0].t().float() * sd
            bd = cd[None, None]
        return kbottle.BlockWeights(
            w1=self.conv1.weight[:, :, 0, 0].t().float() * s1, b1=c1[None, None],
            w2=self.conv2.weight.permute(2, 3, 1, 0).float() * s2, b2=c2[None, None],
            w3=self.conv3.weight[:, :, 0, 0].t().float() * s3, b3=c3[None, None],
            wd=wd, bd=bd,
        )

    def _conv_bns(self) -> List[Tuple[nn.Conv2d, nn.Module]]:
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)]
        return pairs + ([tuple(self.downsample)] if self.downsample is not None else [])

    def _build_fold(self):
        """Stride 1: the fused kernel's ``Packed`` weights; else each conv's
        folded weight and bias for cuDNN, the projection's bias added to
        conv3's."""
        if self.stride == 1:
            return kbottle.pack(self.folded_weights(), self.dtype)
        (w1, b1), (w2, b2), (w3, b3), (wd, bd) = [_fold_conv(conv, bn, self.dtype)
                                                  for conv, bn in self._conv_bns()]
        return w1, b1.to(self.dtype), w2, b2.to(self.dtype), w3, (b3 + bd).to(self.dtype), wd

    def _forward_folded(self, x: torch.Tensor) -> torch.Tensor:
        folded = self._folded(x.device)
        x = x.to(self.dtype)
        if self.stride == 1:
            # NCHW channels_last <-> NHWC contiguous are the same memory
            x_nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            return kbottle.fused_bottleneck(x_nhwc, folded, self.dilation).permute(0, 3, 1, 2)
        w1, b1, w2, b2, w3, b3, wd = folded
        proj = self.downsample[0]
        skip = F.conv2d(x, wd, None, proj.stride, proj.padding, proj.dilation)
        out = _conv_relu(_conv_relu(x, self.conv1, w1, b1), self.conv2, w2, b2)
        return _conv_relu(out, self.conv3, w3, b3, skip)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.folds:
            return self._forward_folded(x)
        dt = self.dtype
        if self.fused:
            # NCHW channels_last <-> NHWC contiguous are the same memory
            x_nhwc = x.to(dt).contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            out = kbottle.fused_bottleneck(x_nhwc, self.folded_weights(), self.dilation)
            return out.permute(0, 3, 1, 2)
        out = torch.relu(self.bn1(_conv(x, self.conv1, dt)))
        out = torch.relu(self.bn2(_conv(out, self.conv2, dt)))
        out = self.bn3(_conv(out, self.conv3, dt))
        if self.downsample is not None:
            x = self.downsample[1](_conv(x, self.downsample[0], dt))
        return torch.relu(out + x)


class ResNet(_Folds, nn.Module):
    """ResNet body returning the layer4 feature map (stride 32, or 16 with DC5)."""

    def __init__(self, depths: Sequence[int] = (3, 4, 23, 3), dc5: bool = False,
                 dtype=torch.float32, conv_impl: str = "xla",
                 conv_stages: Sequence[int] = (1, 2, 3, 4), norm: str = "frozenbn",
                 frozen_stages: int = 1, remat_blocks: bool = False,
                 remat_stages: Sequence[int] = (1, 2, 3, 4)):
        super().__init__()
        self.dtype, self.norm, self.frozen_stages = dtype, norm, frozen_stages
        self.remat_blocks, self.remat_stages = remat_blocks, tuple(remat_stages)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _norm(norm, 64)
        planes = (64, 128, 256, 512)
        strides = (1, 2, 2, 1 if dc5 else 2)
        dilations = (1, 1, 1, 2 if dc5 else 1)
        cin = 64
        for i, (depth, p, s, d) in enumerate(zip(depths, planes, strides, dilations)):
            impl = conv_impl if (i + 1) in conv_stages else "xla"
            blocks = []
            for j in range(depth):
                # torchvision's replace_stride_with_dilation: a stage's first
                # block keeps the dilation before it (1), its projection at
                # stride 1; the later blocks take the stage's dilation
                blocks.append(Bottleneck(
                    cin, p, stride=s if j == 0 else 1, dilation=1 if j == 0 else d,
                    downsample=(j == 0), dtype=dtype, conv_impl=impl, norm=norm,
                ))
                cin = p * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(depths)
        # the stem, the max pool and each stage's strided 3x3 halve the map, rounding up
        self.stride = 4 * 2 ** strides[:self.num_stages].count(2)

    def _stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        remat = (self.remat_blocks and (i + 1) in self.remat_stages
                 and torch.is_grad_enabled())
        for block in getattr(self, f"layer{i + 1}"):
            if remat and not block.fused:
                x = torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return x

    def _conv_bns(self) -> List[Tuple[nn.Conv2d, nn.Module]]:
        return [(self.conv1, self.bn1)]

    def _build_fold(self):
        w, b = _fold_conv(self.conv1, self.bn1, self.dtype)
        return w, b.to(self.dtype)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """The stem's conv, norm and ReLU: x [N, H, W, 3] -> [N, 64, H/2,
        W/2] (channels-last, compute dtype). Folded in bf16 without
        gradient."""
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if self.folds:
            return _conv_relu(x, self.conv1, *self._folded(x.device))
        return torch.relu(self.bn1(_conv(x, self.conv1, self.dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 3] -> [N, h, w, 2048] (NHWC, compute dtype): h, w
        are H, W over ``stride`` (32, or 16 with DC5), rounded up."""
        frozen = min(self.frozen_stages, self.num_stages)
        folding = frozen if torch.is_grad_enabled() else self.num_stages
        with torch.no_grad():  # the frozen prefix
            if self.folds:  # every module this forward folds, rebuilt at once where stale
                refold([self] + [b for i in range(folding) for b in getattr(self, f"layer{i + 1}")],
                       x.device)
            x = F.max_pool2d(self.stem(x), 3, stride=2, padding=1)
            for i in range(frozen):
                x = self._stage(i, x)
        for i in range(frozen, self.num_stages):
            x = self._stage(i, x)
        return x.permute(0, 2, 3, 1)


def build_resnet(name: str, dc5: bool, dtype=torch.float32, depths: Sequence[int] = (),
                 conv_impl: str = "xla", conv_stages: Sequence[int] = (1, 2, 3, 4),
                 frozen_stages: int = 1, remat_blocks: bool = False,
                 remat_stages: Sequence[int] = (1, 2, 3, 4)) -> ResNet:
    norm = "frozenbn"
    if name.endswith("-gn"):
        norm, name = "gn", name[: -len("-gn")]
    if not depths:
        if name == "resnet50":
            depths = (3, 4, 6, 3)
        elif name == "resnet101":
            depths = (3, 4, 23, 3)
        else:
            raise ValueError(f"unsupported backbone {name}")
    return ResNet(depths=tuple(depths), dc5=dc5, dtype=dtype, conv_impl=conv_impl,
                  conv_stages=tuple(conv_stages), norm=norm, frozen_stages=frozen_stages,
                  remat_blocks=remat_blocks, remat_stages=remat_stages)


def downsample_mask(pixel_mask: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour downsample of a [..., H, W] mask: index floor(i * H/h')."""
    h, w = pixel_mask.shape[-2:]
    oh, ow = out_hw
    dev = pixel_mask.device
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) * (h / oh)).long()
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) * (w / ow)).long()
    return pixel_mask[..., ys, :][..., :, xs]
