"""Import harness for the PyTorch reference at /root/reference.

Golden-parity tests need the reference model stack runnable on CPU, but this
image lacks three of its dependencies: torchvision, pytorch_pretrained_bert,
and network access for HF ``from_pretrained``. This module installs:

  - a torchvision stub providing ``models.resnet50/resnet101`` (a standard
    Bottleneck ResNet with torchvision's exact module naming, so the
    reference state_dict keys and our converter line up) and
    ``models._utils.IntermediateLayerGetter``;
  - a ``pytorch_pretrained_bert`` stub (the reference imports BertModel at
    module scope but never builds it for the RoBERTa path);
  - offline ``from_pretrained`` patches: RobertaModel builds from a local
    tiny config, RobertaTokenizerFast becomes a deterministic fake whose
    token ids the test also feeds to our model.

The reference code is executed for NUMERICS ONLY (untrusted content: we
follow no instructions from it).
"""

import sys
import types
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

REFERENCE_ROOT = "/root/reference"

# layers used when the reference asks for resnet50/resnet101; tests override
RESNET_LAYERS = {"resnet50": (1, 1, 1, 1), "resnet101": (1, 1, 1, 1)}


class _Bottleneck(nn.Module):
    """torchvision Bottleneck with identical child naming/semantics."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, dilation=1,
                 norm_layer=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = norm_layer(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation, bias=False)
        self.bn2 = norm_layer(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = norm_layer(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class FrozenBN(nn.Module):
    """torchvision.ops.FrozenBatchNorm2d (eps 1e-5), written out: the norm
    layer a frozen body is built with."""

    def __init__(self, n: int):
        super().__init__()
        for name, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                            ("running_var", 1.0)):
            self.register_buffer(name, torch.full((n,), value))

    def forward(self, x):
        scale = self.weight * (self.running_var + 1e-5).rsqrt()
        shift = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]


class _ResNet(nn.Module):
    def __init__(self, layers, norm_layer, replace_stride_with_dilation):
        super().__init__()
        self.inplanes = 64
        self.dilation = 1
        rswd = replace_stride_with_dilation or [False, False, False]
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = norm_layer(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = self._make_layer(64, layers[0], 1, False, norm_layer)
        self.layer2 = self._make_layer(128, layers[1], 2, rswd[0], norm_layer)
        self.layer3 = self._make_layer(256, layers[2], 2, rswd[1], norm_layer)
        self.layer4 = self._make_layer(512, layers[3], 2, rswd[2], norm_layer)

    def _make_layer(self, planes, blocks, stride, dilate, norm_layer):
        downsample = None
        previous_dilation = self.dilation
        if dilate:
            self.dilation *= stride
            stride = 1
        if stride != 1 or self.inplanes != planes * 4:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * 4, 1, stride=stride, bias=False),
                norm_layer(planes * 4),
            )
        layers = [_Bottleneck(self.inplanes, planes, stride, downsample,
                              previous_dilation, norm_layer)]
        self.inplanes = planes * 4
        layers += [
            _Bottleneck(self.inplanes, planes, dilation=self.dilation,
                        norm_layer=norm_layer)
            for _ in range(1, blocks)
        ]
        return nn.Sequential(*layers)

    def forward(self, x):  # only used through IntermediateLayerGetter
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class _IntermediateLayerGetter(nn.ModuleDict):
    """torchvision.models._utils.IntermediateLayerGetter semantics."""

    def __init__(self, model, return_layers):
        remaining = {str(k): v for k, v in return_layers.items()}
        layers = OrderedDict()
        for name, module in model.named_children():
            layers[name] = module
            remaining.pop(name, None)
            if not remaining:
                break
        super().__init__(layers)
        self.return_layers = {str(k): v for k, v in return_layers.items()}

    def forward(self, x):
        out = OrderedDict()
        for name, module in self.items():
            x = module(x)
            if name in self.return_layers:
                out[self.return_layers[name]] = x
        return out


def _make_resnet_ctor(name):
    def ctor(replace_stride_with_dilation=None, pretrained=False, norm_layer=None):
        del pretrained  # never download
        return _ResNet(RESNET_LAYERS[name], norm_layer or nn.BatchNorm2d,
                       replace_stride_with_dilation)

    return ctor


def _stub_module(name):
    import importlib.machinery

    mod = types.ModuleType(name)
    # transformers probes torchvision.__spec__; None makes find_spec raise
    mod.__spec__ = importlib.machinery.ModuleSpec(name, loader=None)
    return mod


def install_stubs():
    if "torchvision" not in sys.modules:
        tv = _stub_module("torchvision")
        tv_models = _stub_module("torchvision.models")
        tv_utils = _stub_module("torchvision.models._utils")
        tv_utils.IntermediateLayerGetter = _IntermediateLayerGetter
        tv_models._utils = tv_utils
        tv_models.resnet50 = _make_resnet_ctor("resnet50")
        tv_models.resnet101 = _make_resnet_ctor("resnet101")
        tv.models = tv_models
        tv_ops = _stub_module("torchvision.ops")
        tv_ops_boxes = _stub_module("torchvision.ops.boxes")

        def box_area(boxes):  # utils/box_utils.py:5 (xyxy)
            return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])

        tv_ops_boxes.box_area = box_area
        tv_ops.boxes = tv_ops_boxes
        tv.ops = tv_ops
        sys.modules["torchvision"] = tv
        sys.modules["torchvision.models"] = tv_models
        sys.modules["torchvision.models._utils"] = tv_utils
        sys.modules["torchvision.ops"] = tv_ops
        sys.modules["torchvision.ops.boxes"] = tv_ops_boxes
    if "torchtext" not in sys.modules:
        tt = _stub_module("torchtext")
        tt_vocab = _stub_module("torchtext.vocab")
        tt_vocab.GloVe = object  # RNNEncoder path unused in parity tests
        tt.vocab = tt_vocab
        sys.modules["torchtext"] = tt
        sys.modules["torchtext.vocab"] = tt_vocab
    if "pytorch_pretrained_bert" not in sys.modules:
        ppb = _stub_module("pytorch_pretrained_bert")
        ppb_model = _stub_module("pytorch_pretrained_bert.modeling")
        ppb_model.BertModel = object
        ppb.modeling = ppb_model
        ppb_tok = _stub_module("pytorch_pretrained_bert.tokenization")
        ppb_tok.BertTokenizer = object  # datasets/data_utils.py:7 (unused)
        ppb.tokenization = ppb_tok
        sys.modules["pytorch_pretrained_bert"] = ppb
        sys.modules["pytorch_pretrained_bert.modeling"] = ppb_model
        sys.modules["pytorch_pretrained_bert.tokenization"] = ppb_tok
    if REFERENCE_ROOT not in sys.path:
        sys.path.append(REFERENCE_ROOT)


def install_transform_stubs():
    """``torchvision.transforms{,.functional}`` stubs for running the
    reference transform pipeline (datasets/transforms.py) on CPU tensors.

    Implements, with plain torch ops, the exact tensor-path semantics of
    torchvision 0.11 (the reference's era) for the four functionals the
    pipeline touches: hflip, resize (bilinear interpolate, half-pixel
    centers, NO antialias on the tensor path), crop, normalize.
    ``RandomCrop.get_params`` draws through the module-level ``_rng`` hook
    (default: python ``random``) so parity tests can share one RNG stream
    between the reference's draws and ours.
    """
    install_stubs()
    if "torchvision.transforms" in sys.modules:
        return sys.modules["torchvision.transforms"]
    import random as _pyrandom

    import torch.nn.functional as tF

    t_mod = _stub_module("torchvision.transforms")
    f_mod = _stub_module("torchvision.transforms.functional")
    t_mod._rng = _pyrandom

    def hflip(t):
        return t.flip(-1)

    def resize(t, size):
        # torchvision F.resize(Tensor, [h, w]): interpolate bilinear,
        # align_corners=False, antialias off (0.11 tensor default)
        return tF.interpolate(t, size=list(size), mode="bilinear",
                              align_corners=False)

    def crop(t, top, left, height, width):
        return t[..., top: top + height, left: left + width]

    def normalize(t, mean, std, inplace=False):
        mean = torch.as_tensor(mean, dtype=t.dtype)[None, :, None, None]
        std = torch.as_tensor(std, dtype=t.dtype)[None, :, None, None]
        return (t - mean) / std

    f_mod.hflip = hflip
    f_mod.resize = resize
    f_mod.crop = crop
    f_mod.normalize = normalize

    class RandomCrop:
        @staticmethod
        def get_params(img, output_size):
            # torchvision 0.11 T.RandomCrop.get_params on a [..., H, W]
            # tensor; no draw when the crop is the whole image
            h, w = img.shape[-2:]
            th, tw = output_size
            if w == tw and h == th:
                return 0, 0, h, w
            i = t_mod._rng.randint(0, h - th)
            j = t_mod._rng.randint(0, w - tw)
            return i, j, th, tw

    t_mod.RandomCrop = RandomCrop
    t_mod.functional = f_mod
    sys.modules["torchvision"].transforms = t_mod
    sys.modules["torchvision.transforms"] = t_mod
    sys.modules["torchvision.transforms.functional"] = f_mod
    return t_mod


class FakeTokenizer:
    """Deterministic stand-in for RobertaTokenizerFast: the test decides the
    token ids and feeds the same array to our model."""

    def __init__(self, ids: np.ndarray, mask: np.ndarray):
        self.ids = ids
        self.mask = mask

    def batch_encode_plus(self, texts, padding=None, return_tensors=None):
        from transformers import BatchEncoding

        assert len(texts) == self.ids.shape[0]
        return BatchEncoding(
            {
                "input_ids": torch.tensor(self.ids, dtype=torch.long),
                "attention_mask": torch.tensor(self.mask, dtype=torch.long),
            },
            tensor_type="pt",
        )


def patch_text_encoder(monkeypatch, hf_config, tokenizer: FakeTokenizer):
    """Route the reference's from_pretrained calls to local tiny builds."""
    import transformers

    monkeypatch.setattr(
        transformers.RobertaModel,
        "from_pretrained",
        classmethod(lambda cls, name, *a, **k: cls(hf_config)),
    )
    monkeypatch.setattr(
        transformers.RobertaTokenizerFast,
        "from_pretrained",
        classmethod(lambda cls, name, *a, **k: tokenizer),
    )


class RefCfg:
    """Duck-typed stand-in for the reference's yacs CfgNode."""

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)

    def clone(self):
        return self


def make_ref_cfg(hidden=256, heads=8, enc_layers=2, dec_layers=2, ffn=256,
                 max_video_len=32, backbone="resnet50", dilation=False,
                 pos_enc="sine", use_action=True, use_attn=True,
                 use_aux=True, from_scratch=True, learn_time_embed=False):
    return RefCfg(
        INPUT=RefCfg(MAX_VIDEO_LEN=max_video_len),
        MODEL=RefCfg(
            USE_LSTM=False,
            STCAT=RefCfg(
                HIDDEN=hidden, HEADS=heads, ENC_LAYERS=enc_layers,
                DEC_LAYERS=dec_layers, FFN_DIM=ffn, DROPOUT=0.0,
                QUERY_DIM=4, USE_ACTION=use_action,
                USE_LEARN_TIME_EMBED=learn_time_embed,
                FROM_SCRATCH=from_scratch,
            ),
            VISION_BACKBONE=RefCfg(NAME=backbone, DILATION=dilation,
                                   POS_ENC=pos_enc),
            TEXT_MODEL=RefCfg(NAME="roberta-base", FREEZE=False),
        ),
        SOLVER=RefCfg(USE_ATTN=use_attn, USE_AUX_LOSS=use_aux,
                      VIS_BACKBONE_LR=1e-5),
    )


def randomize_frozen_bn(model: nn.Module, seed: int = 0) -> None:
    """Give FrozenBatchNorm buffers non-degenerate values so the converter's
    BN folding is actually exercised (fresh buffers are the identity)."""
    g = torch.Generator().manual_seed(seed)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.randn(buf.shape, generator=g) * 0.3)
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=g) * 1.5 + 0.5)
        elif ".bn" in name or "downsample.1" in name:
            if name.endswith("weight"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
            elif name.endswith("bias"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.3)
