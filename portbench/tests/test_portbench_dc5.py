"""The R101-DC5 serving cell (``hcstvg_r101dc5.serve``) rehearsed on the CPU
at tiny widths, and K3's share of its roofline (``k3_roofline.py``,
``metrics/k3_roofline.serve.py``). Torch only."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.k3_roofline import k3_blocks, k3_call_bound, k3_forward_bound
from portbench.run import Spec, run_cell
from portbench.trace import TraceSummary

from tiny import tiny_conf, tiny_traffic

CELL = "hcstvg_r101dc5.serve"
# layer4 holds layer4.0 (dilation 1, projection) and one block at dilation 2
DC5_TINY = {"VISION_BACKBONE": {"DEPTHS": [1, 1, 1, 2]}}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def _planted(build, dilation):
    """The port's body with layer4.0's 3x3 at ``dilation`` (and as much
    padding): at 2, a body that dilates the stage's first block too."""
    def built(*args, **kw):
        body = build(*args, **kw)
        b = body.layer4[0]
        b.dilation = dilation
        b.conv2.padding, b.conv2.dilation = (dilation, dilation), (dilation, dilation)
        return body
    return built


def _rehearse(bench, monkeypatch, plant=None):
    from stcat_tpu_torch.models import stcat

    if plant is not None:
        monkeypatch.setattr(stcat, "build_resnet", _planted(stcat.build_resnet, plant))
    cell = harness.find(bench["workloads"], CELL, "workload")
    conf = tiny_conf(cell["config"], MODEL=DC5_TINY)
    assert conf["config"]["MODEL"]["VISION_BACKBONE"]["DILATION"] is True
    spec = Spec(bench, cell, 2 ** 31 + 29, 3.0, 0, torch.device("cpu"), conf=conf,
                traffic=tiny_traffic(cell["traffic"]))
    outcome, _ = run_cell(spec)
    assert outcome.attempted > 0 and outcome.failed == 0
    return {c.name: c for c in outcome.checks}


def test_the_cell_finds_its_configuration_mix_and_limits(bench):
    cell = harness.find(bench["workloads"], CELL, "workload")
    assert cell["chips"] == 1
    conf = harness.config_of(bench, cell)
    assert conf["config"]["MODEL"]["VISION_BACKBONE"]["DILATION"] is True
    assert conf["reduced"] == ["MODEL.WEIGHT"] and "MODEL.VISION_BACKBONE.DILATION" in conf["changed"]
    r101 = harness.load_json(harness.BENCH / "configs" / "stcat_r101_hcstvg.json")
    r101["config"]["MODEL"]["VISION_BACKBONE"]["DILATION"] = True
    assert conf["config"] == r101["config"]
    assert set(harness.limits_of(cell)) == {"box_px", "span_gap", "layer4_gap"}
    assert harness.traffic_of(cell)["kind"] == "serve"
    names = {m["name"] for m in harness.metrics_of(bench, cell, "per_layer")}
    assert "k3_roofline.serve" in names


def test_a_tiny_rehearsal_of_the_dc5_cell_is_correct(bench, monkeypatch):
    checks = _rehearse(bench, monkeypatch)
    assert checks and all(c.ok for c in checks.values()), checks


def test_the_dc5_cell_with_layer4_0_at_dilation_2_is_not_correct(bench, monkeypatch):
    checks = _rehearse(bench, monkeypatch, plant=2)
    assert not checks["layer4_gap"].ok, checks


# ---------------------------------------------------------------------------
# K3's share of its roofline
# ---------------------------------------------------------------------------

def test_chip_smokes_k3_cases_are_these_blocks():
    """``chip_smoke.py`` takes K3's shapes and arithmetic from here: its
    cases are the five R101 shapes it always checked (30 launches per served
    forward) and DC5's, layer4's at 28 x 38 (31, two dilated), and summed
    over a forward they give ``k3_forward_bound``."""
    import chip_smoke as cs

    def rows(cases):
        return [(b.h, b.w, b.cin, b.p, b.proj, b.dilation, n) for b, n in cases]

    r101 = [(112, 152, 64, 64, True, 1, 1), (112, 152, 256, 64, False, 1, 2),
            (56, 76, 512, 128, False, 1, 3), (28, 38, 1024, 256, False, 1, 22)]
    assert rows(cs.K3_CASES) == r101 + [(14, 19, 2048, 512, False, 1, 2)]
    assert rows(cs.K3_DC5_CASES) == r101 + [(28, 38, 1024, 512, True, 1, 1),
                                            (28, 38, 2048, 512, False, 2, 2)]
    assert (cs.K3_PER_MICROBATCH, cs.K3_PER_DC5_FORWARD, cs.K3_DILATED_PER_DC5_FORWARD) == (30, 31, 2)
    for dc5, cases in ((False, cs.K3_CASES), (True, cs.K3_DC5_CASES)):
        bound, launches = k3_forward_bound(cs.DEPTHS, dc5, cs.N, cs.CANVAS)
        assert sum(n for _, n in cases) == launches
        assert sum(n * k3_call_bound(cs.N, b) for b, n in cases) == pytest.approx(bound, rel=1e-12)


def test_the_dc5_blocks_are_torchvisions_stride_1_blocks():
    r101 = k3_blocks((3, 4, 23, 3), False, (448, 608))
    dc5 = k3_blocks((3, 4, 23, 3), True, (448, 608))
    assert r101[:-2] == dc5[:-3]
    assert [(b.h, b.w, b.cin, b.p, b.cout, b.dilation, b.proj) for b in dc5[-3:]] == [
        (28, 38, 1024, 512, 2048, 1, True), (28, 38, 2048, 512, 2048, 2, False),
        (28, 38, 2048, 512, 2048, 2, False)]
    assert [(b.h, b.w) for b in r101[-2:]] == [(14, 19)] * 2


def _readings(bench, cell, seconds, entries):
    cell = harness.find(bench["workloads"], cell, "workload")
    summary = TraceSummary(window_s=4.0, busy_s=2.0, kernels=entries + 5,
                           by_name={"void (anonymous namespace)::tc::bottleneck_tc<4>(x)": seconds,
                                    "sm80_xmma_fprop": 0.1},
                           count_by_name={"void (anonymous namespace)::tc::bottleneck_tc<4>(x)":
                                          entries, "sm80_xmma_fprop": 5})
    return SimpleNamespace(kind="serve", trace=summary, conf=harness.config_of(bench, cell),
                           traffic=harness.traffic_of(cell))


def _counters(monkeypatch, **values):
    from stcat_tpu_torch.core import trace

    counters = {k.replace("_", "."): v for k, v in values.items()}
    monkeypatch.setattr(trace, "drain", lambda keep=False: {"spans": [], "counters": counters,
                                                            "anchors": []})


def test_the_reader_gives_the_hand_computed_share(bench, monkeypatch):
    """R101: 60 K3 entries at 30 launches a forward are 2 forwards; their
    least time over the entries' 0.4 s."""
    read = harness.reader("k3_roofline.serve").read
    _counters(monkeypatch, k3_launches=300, serve_forwards=10)
    bound, _ = k3_forward_bound((3, 4, 23, 3), False, 256, (448, 608))
    want = 100.0 * 2 * bound / 0.4
    assert read(_readings(bench, "hcstvg_r101.serve", 0.4, 60)) == pytest.approx(want, rel=1e-12)
    _counters(monkeypatch, k3_launches=310, serve_forwards=10)
    bound, _ = k3_forward_bound((3, 4, 23, 3), True, 256, (448, 608))
    got = read(_readings(bench, CELL, 0.6, 62))
    assert got == pytest.approx(100.0 * 2 * bound / 0.6, rel=1e-12)


def test_the_reader_gives_none_without_what_it_reads(bench, monkeypatch):
    read = harness.reader("k3_roofline.serve").read
    _counters(monkeypatch, k3_launches=300, serve_forwards=10)
    assert read(_readings(bench, "hcstvg_r101.serve", 0.0, 0)) is None  # no K3 entries
    r = _readings(bench, "hcstvg_r101.serve", 0.4, 60)
    assert read(SimpleNamespace(**{**vars(r), "trace": None})) is None
    assert read(SimpleNamespace(**{**vars(r), "kind": "eval"})) is None
    mixed = dict(r.traffic, request_frames=[[64, 0.5], [128, 0.5]])
    assert read(SimpleNamespace(**{**vars(r), "traffic": mixed})) is None
    _counters(monkeypatch, k3_launches=300)  # a port without serve.forwards
    assert read(r) is None
