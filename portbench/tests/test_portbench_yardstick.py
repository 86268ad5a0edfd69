"""The benchmark's arithmetic on the CPU: percentiles and rates over a
window, idle time from a union of intervals, K1's least time against the
smoke test's cases, the operations counted on the meta device, and the
arrivals and request lengths a serving mix names."""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import generate, roofline, stats
from portbench.reference.model import STCAT, arch_of
from portbench.trace import summarize

from tiny import tiny_conf

ROOT = Path(__file__).resolve().parents[2]


def test_percentile_interpolates_and_counts_missing_as_infinite():
    xs = [float(i) for i in range(1, 101)]
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 90) == pytest.approx(90.1)
    assert stats.percentile(xs, 0) == 1.0 and stats.percentile(xs, 100) == 100.0
    # 11 of 100 requests missing: the 90th percentile reaches them
    assert math.isinf(stats.percentile(xs[:89] + [math.inf] * 11, 90))
    assert stats.percentile(xs[:95] + [math.inf] * 5, 90) < math.inf


def test_rate_over_a_window():
    assert stats.rate(30, 10.0) == 3.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_gaps_and_coverage():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (5.0, 5.0)]
    assert stats.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.covered(iv, 1.0, 3.5) == pytest.approx(1.5)
    assert stats.gaps(iv, -1.0, 4.5) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 4.5)]


def test_trace_summary_unions_overlaps_and_names_idle_gaps():
    # two streams overlap on [1, 2]: busy is the union (3 s), not the sum (4 s)
    device = [(0.0, 2.0, "conv"), (1.0, 3.0, "MemcpyHtoD"), (5.0, 6.0, "conv")]
    host = [(0.0, 10.0, "step"), (3.5, 4.5, "next_batch")]
    s = summarize(device, host, 0.0, 8.0)
    assert s.busy_s == pytest.approx(4.0) and s.window_s == 8.0
    assert s.kernels == 2  # the copy is not a kernel
    assert s.by_name["conv"] == pytest.approx(3.0)
    # gaps [3, 5] (begun inside "step") and [6, 8]
    assert s.idle_by_span == {"step": pytest.approx(4.0)}
    s = summarize(device, [(2.5, 5.0, "step"), (2.9, 4.0, "next_batch")], 0.0, 6.0)
    assert s.idle_by_span == {"next_batch": pytest.approx(2.0)}
    assert s.device_ops(1) == [["conv", pytest.approx(3.0)]]


def test_k1_bound_matches_the_smoke_tests_cases():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    cases = roofline.k1_cases(chip_smoke.LANES, chip_smoke.FRAMES, chip_smoke.HEADS, 256,
                              chip_smoke.HW, chip_smoke.L)
    assert [c[1:] for c in cases] == [c[1:] for c in chip_smoke.K1_CASES]
    total, launches = roofline.k1_forward_bound(chip_smoke.LANES, chip_smoke.FRAMES,
                                                chip_smoke.HEADS, 256, chip_smoke.HW,
                                                chip_smoke.L)
    assert launches == chip_smoke.K1_PER_MICROBATCH == 24
    # chip_smoke.py's bound per served forward (PERF.md's kernel table, bytes-bound)
    assert total * 1e3 == pytest.approx(0.633, abs=5e-4)
    assert roofline.PEAK_BF16_FLOPS == chip_smoke.PEAK_FLOPS[torch.bfloat16]
    assert roofline.PEAK_BYTES == chip_smoke.PEAK_BYTES


def test_flops_on_the_meta_device_match_a_real_forward():
    from torch.utils.flop_counter import FlopCounterMode

    arch = arch_of(tiny_conf("stcat_r101_vidstg")["config"])
    meta = roofline.count_flops(arch, 2, 8, (64, 96), 26, train=False)
    model = STCAT(arch).eval()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros(2, 8, 64, 96, 3), torch.ones(2, 8, dtype=torch.bool),
              torch.ones(2, 8, 64, 96, dtype=torch.bool), torch.zeros(2, 26, dtype=torch.long),
              torch.ones(2, 26, dtype=torch.bool))
    assert meta == counter.get_total_flops() > 0
    one = roofline.count_flops(arch, 1, 8, (64, 96), 26, train=False)
    train = roofline.count_flops(arch, 1, 8, (64, 96), 26, train=True,
                                 solver=tiny_conf("stcat_r101_vidstg")["config"]["SOLVER"])
    # a clip's forward, then the backward of everything past the frozen stem:
    # more than the forward, less than three forwards
    assert one < train < 3 * one


def test_flops_per_clip_at_the_published_scale():
    """16.30 TFLOP per training clip at a 448 x 608 canvas (the recipe's
    64 frames) and 11.70 TFLOP per evaluated clip (two 64-frame streams):
    the numbers mfu.train and mfu.eval divide by."""
    conf = __import__("json").loads((ROOT / "portbench/configs/stcat_r101_vidstg.json").read_text())
    arch = arch_of(conf["config"])
    train = roofline.count_flops(arch, 1, 64, (448, 608), 26, True, conf["config"]["SOLVER"])
    evaluate = roofline.count_flops(arch, 2, 64, (448, 608), 26, False)
    assert train / 1e12 == pytest.approx(16.2954, rel=1e-4)
    assert evaluate / 1e12 == pytest.approx(11.6970, rel=1e-4)


MIX = {"rate": 2.8, "layout_seed": 5, "request_frames": 128}


@pytest.mark.parametrize("shape", [{}, {"arrival": "onoff", "on_s": 2.0, "off_s": 3.0}])
def test_every_seed_offers_the_same_arrival_gaps_in_its_own_order(shape):
    mix = dict(MIX, **shape)
    a, b = (generate.arrivals(mix, 51.0, seed) for seed in (2 ** 31 + 1, 2 ** 40 + 3))
    assert len(a) == len(b) == round(2.8 * 51) and a[0] == b[0] == 0.0
    assert (a < 51.0).all() and not (a == b).all()
    if shape:  # only inside the bursts, 2 s of every 5; gaps counted in burst time
        assert (np.mod(a, 5.0) < 2.0 + 1e-9).all()
        a, b = (np.floor(x / 5) * 2 + np.mod(x, 5) for x in (a, b))
    # n - 1 gaps each of one set of n: at most one differs
    da, db = (set(np.round(np.diff(x), 9).tolist()) for x in (a, b))
    assert len(da & db) >= len(a) - 2


def test_request_lengths_follow_the_mix_shares():
    assert (generate.request_lengths(MIX, 7, 3) == 128).all()
    mix = dict(MIX, request_frames=[[64, 0.25], [256, 0.75]])
    a, b = (generate.request_lengths(mix, 40, seed) for seed in (1, 2))
    assert sorted(a.tolist()) == sorted(b.tolist()) == [64] * 10 + [256] * 30
    assert generate.length_set(mix) == [64, 256]
    clips = generate.request_clips(dict(mix, height=8, width=10, videos=2), 9)
    assert [c.shape for c in clips] == [(256, 8, 10, 3)] * 2


@pytest.mark.parametrize("dataset,config", [("VidSTG", "stcat_r101_vidstg"),
                                            ("HC-STVG", "stcat_r101_hcstvg")])
def test_the_reference_samples_the_frames_the_port_samples(dataset, config):
    """The reference's temporal sampling, replayed from the same per-sample
    seed, keeps the frames the port's loader keeps, crop or no crop."""
    from portbench import harness
    from portbench.reference import sampling
    from stcat_tpu_torch.data.sampling import make_hcstvg_input_clip, make_vidstg_input_clip

    conf = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    cfg = harness.port_config(conf)
    port = make_vidstg_input_clip if dataset == "VidSTG" else make_hcstvg_input_clip
    inp = {k: getattr(cfg.INPUT, k) for k in ("TRAIN_SAMPLE_NUM", "TEMP_CROP_PROB", "SAMPLE_FPS")}
    mix = {"width": 320, "height": 240, "videos": 2, "frames_per_video": 600, "items": 12,
           "segment_frames": [160, 600], "span_frames": [64, 150], "layout_seed": 3}
    crops = 0
    for k, it in enumerate(generate.layout(mix)):
        fids = list(range(it["first"], it["first"] + it["n0"]))
        s, e = it["span"]
        item = {"frame_ids": fids, "frame_count": 600,
                "actioness": [float(s <= j <= e) for j in range(it["n0"])],
                "start_heatmap": [0.0] * it["n0"], "end_heatmap": [0.0] * it["n0"]}
        for split in ("train", "test"):
            got = port(cfg, split, dict(item), sampling.sample_rng(cfg.SEED, k, k))["frame_ids"]
            keep = sampling.keep_of(item, dataset, split, inp, sampling.sample_rng(cfg.SEED, k, k))
            assert got == [fids[j] for j in keep]
            plain = sampling.keep_of(item, dataset, split, dict(inp, TEMP_CROP_PROB=0.0),
                                     sampling.sample_rng(cfg.SEED, k, k))
            crops += keep != plain
    assert crops > 0
