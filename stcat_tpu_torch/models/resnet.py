"""ResNet-50/101 vision backbone with frozen batch-norm.

Parameter names follow torchvision (conv1, bn1, layer1.0.conv1, ...,
downsample.0/1) so the reference STCAT state_dict lays over it. Activations
are NCHW tensors in ``torch.channels_last`` memory, i.e. NHWC in memory like
the JAX package, so the fused-bottleneck kernel takes them as NHWC views
without a copy.

FrozenBN keeps torchvision's four buffers and applies
scale = weight * rsqrt(running_var + 1e-5), bias = bias - running_mean * scale
in x's dtype. Stride-1 FrozenBN blocks of the stages in TPU.CONV_STAGES go
through the fused kernel when TPU.CONV_IMPL is "pallas", with FrozenBN folded
into the conv weights as ``stcat_tpu``'s ``Bottleneck._fused`` does; the
stem, the stride-2 first blocks and the GroupNorm variant use
``F.conv2d``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import bottleneck as kbottle

BN_EPS = 1e-5


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


class Bottleneck(nn.Module):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


class ResNet(nn.Module):
    """ResNet body returning the layer4 feature map (stride 32, or 16 with DC5)."""

    def __init__(self, depths: Sequence[int] = (3, 4, 23, 3), dc5: bool = False,
                 dtype=torch.float32, conv_impl: str = "xla",
                 conv_stages: Sequence[int] = (1, 2, 3, 4), norm: str = "frozenbn"):
        super().__init__()
        self.dtype = dtype
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
                blocks.append(Bottleneck(
                    cin, p, stride=s if j == 0 else 1, dilation=d, downsample=(j == 0),
                    dtype=dtype, conv_impl=impl, norm=norm,
                ))
                cin = p * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(depths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 3] -> [N, H/32, W/32, 2048] (NHWC, compute dtype)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = torch.relu(self.bn1(_conv(x, self.conv1, self.dtype)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.permute(0, 2, 3, 1)


def build_resnet(name: str, dc5: bool, dtype=torch.float32, depths: Sequence[int] = (),
                 conv_impl: str = "xla", conv_stages: Sequence[int] = (1, 2, 3, 4)) -> ResNet:
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
                  conv_stages=tuple(conv_stages), norm=norm)


def downsample_mask(pixel_mask: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour downsample of a [..., H, W] mask: index floor(i * H/h')."""
    h, w = pixel_mask.shape[-2:]
    oh, ow = out_hw
    dev = pixel_mask.device
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) * (h / oh)).long()
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) * (w / ow)).long()
    return pixel_mask[..., ys, :][..., :, xs]
