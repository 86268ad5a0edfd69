"""STCAT R101-DC5 in the port, on the CPU (torch only).

The body's layer4 is built as torchvision's ``resnet(replace_stride_with_
dilation=[False, False, True])`` builds it, which DETR and STCAT take for
DC5: layer4.0's 3x3 at dilation 1 beside a stride-1 projection, the later
3x3s at dilation and padding 2. It is held to ``tests/ref_harness.py::
_ResNet`` (torchvision's construction) on each of the body's routes, and the
whole model with ``MODEL.VISION_BACKBONE.DILATION true`` to the benchmark's
plain float32 reference (``portbench/reference/model.py``). With layer4.0's
3x3 planted at dilation 2 (a body that dilates the stage's first block too,
as the JAX package's does) both comparisons fail.
"""

import numpy as np
import pytest
import torch
from torch import nn

from ref_harness import FrozenBN, _ResNet

from stcat_tpu_torch.kernels import bottleneck as kbottle
from stcat_tpu_torch.models.resnet import build_resnet

# layer4 holds one block at dilation 1 (layer4.0, projection) and one at 2
DEPTHS = (1, 1, 1, 2)


def torchvision_dc5(depths=DEPTHS) -> nn.Module:
    return _ResNet(list(depths), FrozenBN, [False, False, True]).eval()


def seeded(module: nn.Module, seed: int) -> None:
    """Convolutions at He scale, frozen statistics away from the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in sorted(module.state_dict().items()):
            if name.endswith(("running_mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
            elif t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=g) * (2.0 / t[0].numel()) ** 0.5)
            else:
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.5)


def plant_dilation(body: nn.Module, dilation: int, stage: int = 4, block: int = 0) -> None:
    """One block's 3x3 at ``dilation`` (and as much padding)."""
    b = getattr(body, f"layer{stage}")[block]
    b.dilation = dilation
    b.conv2.padding, b.conv2.dilation = (dilation, dilation), (dilation, dilation)


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def test_the_dc5_body_is_built_as_torchvision_builds_it():
    """Each block of layer4: stride 1, layer4.0's 3x3 at dilation and
    padding 1 with a stride-1 projection, the later ones at 2; every conv of
    the body has torchvision's shape and geometry, in order."""
    port = build_resnet("resnet101", True, depths=DEPTHS)
    geometry = [(tuple(m.weight.shape), m.stride, m.padding, m.dilation)
                for m in port.modules() if isinstance(m, nn.Conv2d)]
    want = [(tuple(m.weight.shape), m.stride, m.padding, m.dilation)
            for m in torchvision_dc5().modules() if isinstance(m, nn.Conv2d)]
    assert geometry == want
    l4 = port.layer4
    assert [(b.stride, b.dilation, b.conv2.padding) for b in l4] == [(1, 1, (1, 1)), (1, 2, (2, 2))]
    assert l4[0].downsample[0].stride == (1, 1)
    assert all(b.stride == 1 for b in l4)
    assert port.stride == 16
    r101 = build_resnet("resnet101", False, depths=DEPTHS)
    assert [(b.stride, b.dilation) for b in r101.layer4] == [(2, 1), (1, 1)]
    assert r101.stride == 32


# (route, dtype, gradient, largest relative norm of the gap to torchvision's
# fp32 body). xla: the same fp32 convolutions (measured 0 on three seeds).
# pallas: FrozenBN folded into the fused block's weights (K3's plain version
# on the CPU), one more fp32 rounding per conv (measured 0.99-1.06e-6).
# folded: the bf16 forward without gradient, every weight and activation
# rounded to bf16 (8 bits of mantissa) through 17 convolutions (measured
# 0.0064-0.0066). Each limit is about 3 x or more its reading; layer4.0 at
# dilation 2 reads 0.22-0.24 on every route.
ROUTES = [("xla", torch.float32, True, 1e-6),
          ("pallas", torch.float32, True, 1e-5),
          ("folded", torch.bfloat16, False, 2e-2)]
PLANTED_GAP = 0.1


def _routes_body(route, dtype):
    return build_resnet("resnet101", True, dtype=dtype, depths=DEPTHS,
                        conv_impl="xla" if route == "xla" else "pallas", frozen_stages=0).eval()


@pytest.mark.parametrize("planted", [False, True], ids=["as_built", "layer4.0_at_2"])
@pytest.mark.parametrize("route,dtype,grad,tol", ROUTES, ids=[r[0] for r in ROUTES])
def test_the_dc5_body_against_torchvisions_on_each_route(route, dtype, grad, tol, planted):
    tv = torchvision_dc5()
    seeded(tv, 3)
    port = _routes_body(route, dtype)
    port.load_state_dict(tv.state_dict(), strict=True)
    if planted:
        plant_dilation(port, 2)
    x = torch.from_numpy((np.random.RandomState(4).randn(2, 64, 96, 3)).astype(np.float32))
    with torch.no_grad():
        want = tv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    with torch.set_grad_enabled(grad):
        got = port(x)
    assert got.dtype == dtype and tuple(got.shape) == (2, 4, 6, 2048) == tuple(want.shape)
    if route == "folded":  # each layer4 block took K3 with its packed weights
        assert all(isinstance(b._fold[1], kbottle.Packed) for b in port.layer4)
    gap = rel_gap(got.detach(), want)
    if planted:
        assert gap > PLANTED_GAP, gap
    else:
        assert gap <= tol, gap


# ---------------------------------------------------------------------------
# the whole model against the benchmark's plain reference
# ---------------------------------------------------------------------------

def _tiny_dc5():
    """The benchmark's DC5 configuration at the tiny widths of its CPU
    rehearsals (``portbench/tests/tiny.py``), layer4 two blocks deep."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "portbench" / "tests" / "tiny.py"
    spec = importlib.util.spec_from_file_location("portbench_tiny_of_tests", path)
    tiny = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tiny)
    return tiny.tiny_conf("stcat_r101dc5_hcstvg", MODEL={"VISION_BACKBONE": {"DEPTHS": list(DEPTHS)}})


def _whole(planted: bool):
    """(port's out, reference's out, port's layer4, reference's layer4) on
    the same seeded weights and frames, fp32."""
    from portbench import harness, weights
    from portbench.reference import infer as rinfer
    from portbench.reference.model import STCAT, arch_of
    from stcat_tpu_torch.core.batch import VideoBatch
    from stcat_tpu_torch.models import build_model

    conf = _tiny_dc5()
    arch = arch_of(conf["config"])
    assert arch["DILATION"] is True
    state = weights.draw(arch, 2 ** 31 + 23, torch.device("cpu"))
    port = build_model(harness.port_config(conf), "cpu").eval()
    port.load_state_dict(state)
    if planted:
        plant_dilation(port.vis_encoder[0].body, 2)
    ref = STCAT(arch).eval()
    ref.load_state_dict(state)
    inp = conf["config"]["INPUT"]
    rng = np.random.RandomState(5)
    streams = [(torch.from_numpy(rng.randint(0, 255, (t, 48, 64, 3), dtype=np.uint8)), text)
               for t, text in ((8, "the man in the black coat turns"), (6, "a woman sits down"))]
    inputs = rinfer.model_inputs(streams, 8, inp["RESOLUTION"], inp["PIXEL_MEAN"],
                                 inp["PIXEL_STD"], inp["MAX_QUERY_LEN"],
                                 conf["config"]["MODEL"]["TEXT_MODEL"]["VOCAB_SIZE"])
    feats = {}
    hooks = [m.vis_encoder[0].body.register_forward_hook(
        lambda mod, a, out, k=k: feats.__setitem__(k, out.float())) for k, m in
        (("port", port), ("ref", ref))]
    with harness.exact_fp32(), torch.no_grad():
        got = port(VideoBatch(*inputs))
        want = ref(*inputs)
    for h in hooks:
        h.remove()
    return got, want, feats["port"], feats["ref"], inputs[1]


@pytest.mark.parametrize("planted", [False, True], ids=["as_built", "layer4.0_at_2"])
def test_the_whole_dc5_model_against_the_plain_reference(planted):
    """Boxes (absolute, normalised), span logits and layer4 features
    (relative norm of the gap), fp32 on both sides: summation order alone
    (measured under 3e-7), held at 1e-5; layer4.0 at dilation 2 moves all
    three past it (box 8.8e-4, spans 8.3e-3, layer4 0.082)."""
    got, want, f_port, f_ref, valid = _whole(planted)
    assert tuple(f_port.shape) == tuple(f_ref.shape) and f_port.shape[1:3] == (4, 6)
    box = float((got["pred_boxes"] - want["pred_boxes"])[valid].abs().max())
    sted = rel_gap(got["pred_sted"][valid], want["pred_sted"][valid])
    layer4 = rel_gap(f_port, f_ref)
    if planted:
        assert layer4 > 0.05 and box > 1e-5 and sted > 1e-5, (box, sted, layer4)
    else:
        assert max(box, sted, layer4) <= 1e-5, (box, sted, layer4)
