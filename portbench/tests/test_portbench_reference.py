"""The plain reference against the configuration it is given: its ResNet's
geometry is torchvision's with and without DC5, and ``arch_of`` refuses
every key the port's model or the training loss reads at a value the
reference does not model. Torch only, on the CPU."""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import re
from pathlib import Path

import pytest
import torch
from torch import nn

from portbench import harness
from portbench.reference import model as ref
from portbench.run import Spec, run_cell

from tiny import tiny_conf, tiny_traffic

ROOT = Path(__file__).resolve().parents[2]
DEPTHS = [(1, 1, 1, 2), (3, 4, 23, 3)]


def torchvision_resnet(depths, dc5: bool) -> nn.Module:
    """``tests/ref_harness.py``'s restatement of torchvision's ResNet, with
    the reference's FrozenBN as its norm."""
    spec = importlib.util.spec_from_file_location("ref_harness_of_portbench",
                                                  ROOT / "tests" / "ref_harness.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._ResNet(list(depths), ref.FrozenBN, [False, False, dc5])


class Recording(ref.Ops):
    """float32 products that note each convolution's geometry."""

    def __init__(self):
        self.calls = []

    def conv(self, x, w, stride=1, padding=0, dilation=1):
        self.calls.append((tuple(w.shape), stride, padding, dilation))
        return super().conv(x, w, stride, padding, dilation)


@pytest.mark.parametrize("dc5", [False, True])
@pytest.mark.parametrize("depths", DEPTHS)
def test_every_conv_has_torchvisions_geometry(depths, dc5):
    """Each convolution the reference's body runs, in order, has the shape,
    stride, padding and dilation of torchvision's conv at that place
    (``replace_stride_with_dilation [False, False, dc5]``)."""
    ops = Recording()
    with torch.device("meta"):
        body = ref.ResNet(ops, depths, dc5=dc5)
        out = body(torch.empty(1, 64, 96, 3))
        expected = [(tuple(m.weight.shape), m.stride[0], m.padding[0], m.dilation[0])
                    for m in torchvision_resnet(depths, dc5).modules()
                    if isinstance(m, nn.Conv2d)]
    assert ops.calls == expected
    assert out.shape == ((1, 4, 6, 2048) if dc5 else (1, 2, 3, 2048))
    layer4 = [c for c in ops.calls if c[0][1] == 512 and c[0][2] == 3]
    assert [c[1:] for c in layer4] == ([(1, 1, 1)] + [(1, 2, 2)] * (depths[3] - 1) if dc5
                                       else [(2, 1, 1)] + [(1, 1, 1)] * (depths[3] - 1))


def _seeded(module: nn.Module, seed: int) -> None:
    """Convolutions at 2 / fan_in, frozen batch norms off the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in sorted(module.state_dict().items()):
            if name.endswith("running_mean") or name.endswith("bias"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
            elif t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=g) * (2.0 / t[0].numel()) ** 0.5)
            else:
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.5)


def test_the_dc5_body_agrees_with_torchvisions():
    body = ref.ResNet(ref.FP32, DEPTHS[0], dc5=True)
    _seeded(body, 7)
    tv = torchvision_resnet(DEPTHS[0], True)
    tv.load_state_dict(body.state_dict())
    x = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(8))
    with harness.exact_fp32(), torch.no_grad():
        got = body.eval()(x)
        want = tv.eval()(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)
    assert got.shape == (2, 4, 6, 2048)
    assert float((got - want).abs().max()) <= 1e-5
    assert float(want.abs().max()) > 0.1


# ---------------------------------------------------------------------------
# keys the reference refuses
# ---------------------------------------------------------------------------

REFUSED = [
    ("MODEL.VISION_BACKBONE.NAME", "resnet101-gn"),
    ("MODEL.VISION_BACKBONE.NAME", "resnet50-gn"),
    ("MODEL.VISION_BACKBONE.POS_ENC", "sineHW"),
    ("MODEL.VISION_BACKBONE.POS_ENC", "learned"),
    ("MODEL.VISION_BACKBONE.FREEZE", True),
    ("MODEL.TEXT_MODEL.FREEZE", True),
    ("MODEL.TEXT_MODEL.LOCAL_PATH", "tokenizer/roberta-base"),
    ("MODEL.USE_LSTM", True),
    ("MODEL.QUERY_NUM", 2),
    ("MODEL.STCAT.QUERY_DIM", 2),
    ("MODEL.STCAT.USE_LEARN_TIME_EMBED", True),
    ("MODEL.STCAT.USE_ACTION", False),
    ("MODEL.STCAT.FROM_SCRATCH", False),
    ("SOLVER.USE_ATTN", False),
    ("SOLVER.USE_AUX_LOSS", False),
]


def _recipe(name="stcat_r101_hcstvg"):
    return copy.deepcopy(harness.load_json(harness.BENCH / "configs" / f"{name}.json")["config"])


def _set(cfg, key, value):
    *path, last = key.split(".")
    node = cfg
    for part in path:
        node = node.setdefault(part, {})
    node[last] = value
    return cfg


@pytest.mark.parametrize("key,value", REFUSED)
def test_arch_of_refuses_a_key_the_reference_does_not_model(key, value):
    with pytest.raises(ValueError, match=re.escape(f"{key} = {value!r}")):
        ref.arch_of(_set(_recipe(), key, value))


@pytest.mark.parametrize("name", ["stcat_r101_hcstvg", "stcat_r101_vidstg"])
def test_each_configuration_passes_and_dc5_reaches_the_reference(name):
    cfg = _recipe(name)
    assert ref.arch_of(cfg)["DILATION"] is False
    assert ref.arch_of(_set(cfg, "MODEL.VISION_BACKBONE.DILATION", True))["DILATION"] is True


def test_a_run_with_a_refused_key_stops_before_set_up():
    bench = harness.load_benchmark()
    cell = bench["workloads"][0]
    conf = tiny_conf(cell["config"], MODEL={"STCAT": {"USE_ACTION": False}})
    with pytest.raises(ValueError, match="MODEL.STCAT.USE_ACTION = False"):
        Spec(bench, cell, 1, 1.0, 0, torch.device("cpu"), conf=conf,
             traffic=tiny_traffic(cell["traffic"]))


def _fields(node, prefix):
    for f in dataclasses.fields(node):
        value = getattr(node, f.name)
        if dataclasses.is_dataclass(value):
            yield from _fields(value, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", value


def _read_by_model_and_loss(node, prefix):
    """Keys of ``node`` whose names the port's model, its criterion or its
    training step (where the loss is called) spell out."""
    sources = sorted((ROOT / "stcat_tpu_torch" / "models").glob("*.py")) + [
        ROOT / "stcat_tpu_torch" / "train" / name for name in ("criterion.py", "step.py")]
    tokens = set()
    for path in sources:
        tokens |= set(re.findall(r"\b[A-Z][A-Z0-9_]+\b", path.read_text()))
    return [(k, v) for k, v in _fields(node, prefix) if k.rsplit(".", 1)[1] in tokens]


def test_every_key_of_the_model_and_the_loss_is_modelled_refused_or_inert():
    """Each field of the port's MODEL, and each SOLVER and INPUT field the
    model or the loss reads, is followed by the reference, refused at a value
    it does not model, or named inert with its reason; a refused key's
    default in the port is one the reference models. The TPU node only
    routes the port and stays free."""
    from stcat_tpu_torch.config import default_config

    cfg = default_config()
    keys = (list(_fields(cfg.MODEL, "MODEL.")) + _read_by_model_and_loss(cfg.SOLVER, "SOLVER.")
            + _read_by_model_and_loss(cfg.INPUT, "INPUT."))
    assert {k for k, _ in keys} >= {"SOLVER.USE_ATTN", "SOLVER.EOS_COEF", "INPUT.MAX_VIDEO_LEN"}
    inert = lambda k: any(k == i or (i.endswith(".") and k.startswith(i))  # noqa: E731
                          for i in ref.INERT)
    loose = [k for k, _ in keys if k not in ref.MODELLED and k not in ref.ONLY and not inert(k)]
    assert not loose, f"neither modelled, refused nor inert: {loose}"
    for key, default in keys:
        if key in ref.ONLY:
            assert default in ref.ONLY[key], (key, default)
    assert set(ref.ONLY) == {k for k, _ in REFUSED}
    assert all(reason for reason in ref.INERT.values())


# Where a key outside ``arch_of`` reaches the reference, spelled as its code
# reads it from the key's group: ``total_loss``'s ``solver`` is the SOLVER
# group, ``reference_answer``'s ``cfg_input`` the INPUT group.
READ_AS = {"SOLVER.": ("reference/train.py", 'solver["{}"]'),
           "INPUT.": ("kinds/answers.py", 'cfg_input["{}"]')}
ARCH_KEYS = [k for k in ref.MODELLED
             if k.startswith("MODEL.") or k in ("SOLVER.VIS_BACKBONE_LR", "INPUT.MAX_VIDEO_LEN")]


def _other(value):
    """A value of the same kind that differs from ``value``."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value * 2 + 1
    return [v + 1 for v in value]


@pytest.mark.parametrize("key", ref.MODELLED)
def test_each_key_called_modelled_is_read_by_the_reference(key):
    """A key ``arch_of`` reads changes what it returns; a loss or input key
    is read by its full path where the reference computes with it."""
    cfg = _recipe()
    if key in ARCH_KEYS:
        value = ref._lookup(cfg, key)
        value = {"MODEL.VISION_BACKBONE.DEPTHS": [1, 1, 1, 2],
                 "MODEL.VISION_BACKBONE.DILATION": True}[key] if value is ref._ABSENT else _other(value)
        assert ref.arch_of(_set(copy.deepcopy(cfg), key, value)) != ref.arch_of(cfg), key
    else:
        group, name = key.split(".", 1)
        path, spelling = READ_AS[f"{group}."]
        assert spelling.format(name) in (harness.BENCH / path).read_text(), key


def test_the_port_default_configuration_passes():
    from stcat_tpu_torch.config import default_config

    arch = ref.arch_of(dataclasses.asdict(default_config()))
    assert arch["DEPTHS"] == (3, 4, 23, 3) and arch["DILATION"] is False


# ---------------------------------------------------------------------------
# a tiny DC5 rehearsal of the serving cell
# ---------------------------------------------------------------------------

DC5 = {"VISION_BACKBONE": {"DEPTHS": [1, 1, 1, 2], "DILATION": True}}


def _block_dilation(build, dilation, stage=4, block=0):
    """The port's body with one block's 3x3 at ``dilation`` (and as much
    padding): layer4.0 at 1 is torchvision's DC5, at 2 the fault of a body
    that dilates the stage's first block too."""
    def built(*args, **kw):
        body = build(*args, **kw)
        b = getattr(body, f"layer{stage}")[block]
        b.dilation = dilation
        b.conv2.padding, b.conv2.dilation = (dilation, dilation), (dilation, dilation)
        return body
    return built


def _dc5_conf():
    return tiny_conf("stcat_r101_hcstvg", MODEL=DC5)


@pytest.mark.parametrize("first_dilation", [2, 1])
def test_the_port_body_against_the_reference_body_under_dc5(monkeypatch, first_dilation):
    """The port's model as the serving cell builds it, with the benchmark's
    weights, against the reference on the same frames: with layer4.0's 3x3
    at dilation 2 it departs from the reference by over a hundredth of the
    features' largest magnitude (0.15 on these seeds); with torchvision's
    layer4.0 the two agree to float32 rounding (4e-7)."""
    from stcat_tpu_torch.models import build_model, stcat

    from portbench import weights

    monkeypatch.setattr(stcat, "build_resnet", _block_dilation(stcat.build_resnet, first_dilation))
    conf = _dc5_conf()
    arch = ref.arch_of(conf["config"])
    state = weights.draw(arch, 2 ** 31 + 19, torch.device("cpu"))
    port = build_model(harness.port_config(conf), "cpu")
    port.load_state_dict(state)
    reference = ref.STCAT(arch)
    reference.load_state_dict(state)
    x = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(9))
    with harness.exact_fp32(), torch.no_grad():
        got = port.vis_encoder[0].body(x).float()
        want = reference.vis_encoder[0].body(x)
    assert got.shape == want.shape == (2, 4, 6, 2048)
    share = float((got - want).abs().max() / want.abs().max())
    if first_dilation == 1:
        assert share <= 1e-5, share
    else:
        assert share >= 1e-2, share


def _serve(monkeypatch, conf, plant):
    from stcat_tpu_torch.models import stcat

    monkeypatch.setattr(stcat, "build_resnet", _block_dilation(stcat.build_resnet, *plant))
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], "hcstvg_r101.serve", "workload")
    spec = Spec(bench, cell, 2 ** 31 + 17, 3.0, 0, torch.device("cpu"), conf=conf,
                traffic=tiny_traffic(cell["traffic"]))
    outcome, _ = run_cell(spec)
    assert outcome.attempted > 0 and outcome.failed == 0
    return {c.name: c for c in outcome.checks}


def test_a_tiny_dc5_serving_rehearsal_with_torchvisions_layer4_is_correct(monkeypatch):
    """The serving cell run end to end on a DC5 configuration: the harness
    takes it, and the port with torchvision's layer4.0 is correct."""
    checks = _serve(monkeypatch, _dc5_conf(), (1,))
    assert checks and all(c.ok for c in checks.values()), checks


@pytest.mark.parametrize("conf,plant", [(_dc5_conf, (2,)), (lambda: tiny_conf("stcat_r101_hcstvg"),
                                                              (2, 4, 0))],
                         ids=["dc5_layer4.0_at_2", "r101_layer4.0_at_2"])
def test_a_backbone_block_at_the_wrong_dilation_is_not_correct(monkeypatch, conf, plant):
    """One 3x3 of the body at the wrong dilation: ``layer4_gap``, the
    window's layer4 features against the reference's, fails the run (the
    served answers stay inside their limits at these widths)."""
    checks = _serve(monkeypatch, conf(), plant)
    assert not checks["layer4_gap"].ok, checks
