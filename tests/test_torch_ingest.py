"""The port's other input paths against the JAX package's, on the CPU.

The host pixel path (``TPU.DEVICE_PREPROCESS false``: the transform plan
replayed on float32 frames on the host, ``build_batch``) and the yuv420
ingest (``TPU.INGEST_LAYOUT yuv420``: luma and half-size chroma planes,
resampled and converted to RGB by ``preprocess``), module by module and
through the loader, ``do_eval`` and ``train()``. The same numpy inputs go
through both packages. Tolerances: the host-side numpy functions bitwise;
the yuv ``preprocess`` at atol 1e-5 (the rgb branch's, the fp32 resample
weights' rounding); the loaders' batches field for field; ``do_eval`` and
``train()`` at the tolerances of tests/test_torch_eval.py and
tests/test_torch_slice.py.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from stcat_tpu.config import merge_from_list
from stcat_tpu.core import batch as jbatch
from stcat_tpu.data import batching as jbat, decode as jdec, synthetic as jsyn
from stcat_tpu.data import transforms as jtf
from stcat_tpu.data.loader import Loader as JLoader
from stcat_tpu.data.tokenize import HashTokenizer as JHashTokenizer
from stcat_tpu.ops.preprocess import preprocess as jpreprocess
from test_torch_train import NO_DROPOUT, jax_variables, port_cfg

from stcat_tpu_torch.core import batch as pbatch
from stcat_tpu_torch.core.prefetch import prefetch_to_device
from stcat_tpu_torch.data import batching as pbat, decode as pdec, synthetic as psyn
from stcat_tpu_torch.data import transforms as ptf
from stcat_tpu_torch.data.loader import Loader as PLoader
from stcat_tpu_torch.data.tokenize import HashTokenizer
from stcat_tpu_torch.ops.preprocess import preprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the decoder that serves a JPEG corpus: native libjpeg wherever it builds
JPEG_ROUTE = ("native" if shutil.which("g++") and os.path.exists("/usr/include/jpeglib.h")
              else "pil")
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
HOST = ["TPU.DEVICE_PREPROCESS", "false"]
YUV = ["TPU.INGEST_LAYOUT", "yuv420"]


def _clip(rng, t, h, w):
    """A smooth coloured clip with noise, uint8 [t, h, w, 3]."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = np.stack([60 + 2 * xx, 40 + 3 * yy, 120 + xx - yy], -1)[None]
    noise = rng.integers(-20, 21, (t, h, w, 3))
    return np.clip(base + noise + 5 * np.arange(t)[:, None, None, None], 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# host-side functions: bitwise
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,oh,ow", [(24, 32, 48, 64), (37, 53, 20, 29), (40, 40, 40, 40),
                                       (17, 90, 33, 7)])
def test_bilinear_resize_matches_jax(h, w, oh, ow):
    frames = np.random.default_rng(h * w).random((3, h, w, 3), dtype=np.float32)
    a, b = ptf.bilinear_resize(frames, oh, ow), jtf.bilinear_resize(frames, oh, ow)
    assert a.dtype == b.dtype == np.float32 and a.shape == (3, oh, ow, 3)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("is_train", [True, False])
def test_transform_call_matches_jax(is_train):
    """VideoTransform.__call__ (plan, apply_pixels, normalise, boxes and
    text) on the same sample and generator, over seeds that draw flips,
    the resize -> crop -> resize branch and plain resizes: every key
    bitwise."""
    ours = ptf.VideoTransform(416, is_train=is_train)
    theirs = jtf.VideoTransform(416, is_train=is_train)
    branches = set()
    for seed in range(8):
        rng = np.random.default_rng(seed)
        f = rng.random((3, 300, 460, 3), dtype=np.float32)
        boxes = np.asarray([[200.0, 100.0, 300.0, 220.0]] * 3, np.float32)
        sample = {"frames": f, "boxes": boxes, "text": "the man on the left", "item_id": seed}
        a = ours(dict(sample), np.random.default_rng(100 + seed))
        b = theirs(dict(sample), np.random.default_rng(100 + seed))
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
        plan, _, _ = ours.plan((300, 460), boxes, "x", np.random.default_rng(100 + seed))
        np.testing.assert_array_equal(ptf.apply_pixels(f, plan), jtf.apply_pixels(f, plan))
        branches.add((plan.flip, tuple(op[0] for op in plan.ops)))
    if is_train:
        assert {flip for flip, _ in branches} == {False, True}
        assert any("crop" in ops for _, ops in branches)


def _host_samples(rng, sizes):
    samples = []
    for i, (t, h, w) in enumerate(sizes):
        act = np.zeros(t, np.float32)
        act[1: t - 1] = 1.0
        samples.append({
            "frames": rng.standard_normal((t, h, w, 3)).astype(np.float32),
            "boxes_cxcywh": rng.uniform(0.1, 0.9, (t - 2, 4)).astype(np.float32),
            "actioness": act, "text": f"clip {i} on the right", "item_id": i,
            "frame_ids": list(range(t)), "ori_size": (h + 5, w + 7), "qtype": "declar"})
    return samples


def _assert_same(a, b):
    """Two batch containers (or targets) field for field, None fields too."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype, f.name
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f.name)
        else:
            assert x == y, f.name


def test_build_batch_matches_jax():
    """Clips of two durations and sizes (one 64 high, one 64 wide) on a
    64x64 canvas: frames, masks, tokens, targets and meta as JAX's."""
    samples = _host_samples(np.random.default_rng(0), [(5, 37, 50), (7, 64, 31)])
    pb, pt, pm = pbat.build_batch(samples, 8, HashTokenizer(128), 10)
    jb, jt, jm = jbat.build_batch(samples, 8, JHashTokenizer(128), 10)
    assert isinstance(pb, pbatch.VideoBatch) and pb.frames.shape == (2, 8, 64, 64, 3)
    _assert_same(pb, jb)
    _assert_same(pt, jt)
    assert pm == jm


@pytest.mark.parametrize("t,h,w", [(2, 7, 9), (3, 36, 52), (1, 1, 1), (2, 480, 641)])
def test_rgb_to_yuv420_matches_jax(t, h, w):
    rgb = np.random.default_rng(h + w).integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    (y, c), (jy, jc) = pdec.rgb_to_yuv420(rgb), jdec.rgb_to_yuv420(rgb)
    assert y.shape == (t, h, w) and c.shape == (t, (h + 1) // 2, (w + 1) // 2, 2)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(c, jc)


def _yuv_samples(rng, sizes, flips):
    """Raw yuv420 samples of coloured clips of the given (t, h, w), each
    with an eval plan to 32x48-ish and the given flips."""
    samples = []
    for i, ((t, h, w), flip) in enumerate(zip(sizes, flips)):
        y, cbcr = pdec.rgb_to_yuv420(_clip(rng, t, h, w))
        plan, _, text = ptf.VideoTransform(32).plan((h, w), np.zeros((0, 4), np.float32),
                                                    f"clip {i}")
        plan = dataclasses.replace(plan, flip=flip)
        act = np.zeros(t, np.float32)
        act[t // 2:] = 1.0
        samples.append({"frames_y": y, "frames_cbcr": cbcr, "plan": plan, "text": text,
                        "actioness": act, "boxes_cxcywh": np.full((t - t // 2, 4), 0.5,
                                                                  np.float32),
                        "item_id": i, "frame_ids": list(range(t)), "ori_size": (h, w)})
    return samples


def test_build_raw_batch_yuv_matches_jax():
    """Odd sizes (the chroma plane's replicated row and column, capped at
    half the canvas), a flipped clip and a clip filling its canvas."""
    samples = _yuv_samples(np.random.default_rng(1), [(4, 37, 53), (3, 64, 63), (4, 21, 128)],
                           [False, True, True])
    tok, jtok = HashTokenizer(128), JHashTokenizer(128)
    pb, pt, pm = pbat.build_raw_batch(samples, 4, tok, 8)
    jb, jt, jm = jbat.build_raw_batch(samples, 4, jtok, 8)
    assert pb.frames_u8 is None and pb.frames_y.shape == (3, 4, 64, 128)
    assert pb.frames_cbcr.shape == (3, 4, 32, 64, 2)
    _assert_same(pb, jb)
    _assert_same(pt, jt)
    assert pm == jm
    sig = pbat.raw_batch_signature(samples, [4])
    assert sig == jbat.raw_batch_signature(samples, [4])
    assert sig[:3] == (3, 4, (64, 128)) and sig[-1] == "yuv420"


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("sizes", [[(3, 37, 53), (2, 36, 52)], [(2, 63, 35), (2, 17, 121)]])
def test_yuv_preprocess_matches_jax(flip, sizes):
    """preprocess of a yuv420 raw batch (coloured clips of odd widths and
    heights, flipped or not) against the JAX preprocess at atol 1e-5; the
    masks and the rest of the VideoBatch exactly. The same clips through
    the rgb layout agree with it within 4:2:0's chroma quantisation."""
    rng = np.random.default_rng(len(sizes[0]) + flip)
    samples = _yuv_samples(rng, sizes, [flip, not flip])
    t = max(s[0] for s in sizes)
    raw, _, _ = pbat.build_raw_batch(samples, t, HashTokenizer(128), 8)
    jraw, _, _ = jbat.build_raw_batch(samples, t, JHashTokenizer(128), 8)
    ours = preprocess(pbatch.to_device(raw, torch.device("cpu")), MEAN, STD)
    theirs = jpreprocess(jraw, MEAN, STD)
    np.testing.assert_allclose(ours.frames.numpy(), np.asarray(theirs.frames), atol=1e-5, rtol=0)
    for name in ("frame_valid", "pixel_valid", "token_ids", "token_valid"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)), err_msg=name)


def test_yuv_batch_splits_into_streams_like_jax():
    """An eval batch in the yuv420 layout at an odd frame count: the host
    split (subsample_stream + stack_streams) and the device split
    (device_split_streams, in torch) equal the JAX package's, the chroma
    plane split along its frame axis and frames_u8 left None."""
    samples = _yuv_samples(np.random.default_rng(2), [(5, 37, 53), (4, 40, 60)], [False, True])
    raw, _, _ = pbat.build_raw_batch(samples, 5, HashTokenizer(128), 8)
    jraw, _, _ = jbat.build_raw_batch(samples, 5, JHashTokenizer(128), 8)
    host = pbatch.stack_streams(pbatch.subsample_stream(raw, 0), pbatch.subsample_stream(raw, 1))
    dev = pbatch.device_split_streams(pbatch.to_device(raw, torch.device("cpu")))
    want = jbatch.device_split_streams(jraw)
    assert host.frames_u8 is None and dev.frames_u8 is None and want.frames_u8 is None
    assert host.frames_cbcr.shape == (4, 3, 32, 32, 2)
    for f in dataclasses.fields(host):
        x = getattr(host, f.name)
        if x is None or not hasattr(x, "shape"):
            assert x == getattr(dev, f.name) == getattr(want, f.name), f.name
            continue
        np.testing.assert_array_equal(x, np.asarray(getattr(want, f.name)), err_msg=f.name)
        np.testing.assert_array_equal(getattr(dev, f.name).numpy(), x, err_msg=f.name)
    np.testing.assert_array_equal(pbatch.subsample_stream(raw, 1).frames_cbcr,
                                  raw.frames_cbcr[:, 1::2])


def test_prefetch_carries_the_host_and_yuv_batches():
    """prefetch_to_device (the CPU placement) turns every array field of a
    host-path VideoBatch and of a yuv RawVideoBatch into a tensor of the
    same values, and keeps the None planes None."""
    host = pbat.build_batch(_host_samples(np.random.default_rng(3), [(4, 20, 30)]), 4,
                            HashTokenizer(128), 8)
    yuv = pbat.build_raw_batch(_yuv_samples(np.random.default_rng(4), [(4, 21, 33)], [True]),
                               4, HashTokenizer(128), 8)
    for item in (host, yuv):
        (out,) = list(prefetch_to_device(iter([item]), "cpu"))
        for a, b in zip(out[:2], item[:2]):
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(y, np.ndarray):
                    assert isinstance(x, torch.Tensor)
                    np.testing.assert_array_equal(x.numpy(), y, err_msg=f.name)
                else:
                    assert x == y, f.name
        assert out[2] == item[2]
    assert out[0].frames_u8 is None


# --------------------------------------------------------------------------
# the loader: batches field for field
# --------------------------------------------------------------------------

def _loader_cfg(tmp_path, extra=()):
    return tiny_cfg(["DATA_DIR", str(tmp_path), "INPUT.RESOLUTION", 64,
                     "INPUT.TRAIN_SAMPLE_NUM", 8, "INPUT.SAMPLE_FPS", 2,
                     "INPUT.MAX_QUERY_LEN", 12, "TPU.FRAME_BUCKETS", "[8,16,32,64]",
                     "SOLVER.MAX_EPOCH", 2, "DATALOADER.NUM_WORKERS", 2, "SEED", 11, *extra])


def _assert_same_batches(port_batches, jax_batches):
    assert len(port_batches) == len(jax_batches)
    for (pb, pt, pm), (jb, jt, jm) in zip(port_batches, jax_batches):
        assert type(pb).__name__ == type(jb).__name__
        _assert_same(pb, jb)
        _assert_same(pt, jt)
        assert pm == jm


@pytest.mark.parametrize("opts", [HOST, YUV], ids=["host", "yuv420"])
def test_train_loader_matches_jax_with_resume(tmp_path, opts):
    """The train loader over two reshuffled epochs of 7 items in batches of
    2, the JPEG corpus decoded natively on both sides (where the decoder
    builds; through PIL on both where it does not): the host path's
    VideoBatches (plans replayed on the host: flips, crops, resizes) or the
    yuv420 RawVideoBatches equal the JAX Loader's field for field, targets
    and meta too; a loader resumed at start_iter 3 gives the uninterrupted
    run's batches from the fourth on."""
    jcfg = _loader_cfg(tmp_path, ["INPUT.RESOLUTION", 416, *opts])
    pcfg = port_cfg(jcfg)
    jsyn.write_synthetic_cache(str(tmp_path), "VidSTG", "train", n_items=7, n_frames=20,
                               width=400, height=300)
    assert jsyn.materialize_frame_corpus(str(tmp_path), "VidSTG", "train") == 7 * 20
    jds, pds = jsyn.SyntheticDataset(jcfg, "train"), psyn.SyntheticDataset(pcfg, "train")
    jl = JLoader(jcfg, jds, global_batch=2, is_train=True)
    pl = PLoader(pcfg, pds, global_batch=2, is_train=True)
    assert pl.raw == jl.raw == (opts is YUV)
    jbatches, pbatches = list(jl), list(pl)
    assert len(pbatches) == 8
    _assert_same_batches(pbatches, jbatches)
    resumed = list(PLoader(pcfg, pds, global_batch=2, is_train=True, start_iter=3))
    _assert_same_batches(resumed, jbatches[3:])
    if opts is YUV:
        assert all(b.frames_u8 is None for b, _, _ in pbatches)
        plans = [f for b, _, _ in pbatches for f in b.flip]
        assert any(plans) and not all(plans)
    else:
        assert all(isinstance(b, pbatch.VideoBatch) for b, _, _ in pbatches)
    routes = pds.decode_routes.counts()
    assert routes[JPEG_ROUTE] == 8 * 2 + 5 * 2 and sum(routes.values()) == 8 * 2 + 5 * 2


@pytest.mark.parametrize("opts", [HOST, YUV], ids=["host", "yuv420"])
@pytest.mark.parametrize("dataset", ["VidSTG", "HC-STVG"])
def test_eval_loader_matches_jax_with_pads_and_grouping(tmp_path, opts, dataset):
    """One eval pass over 5 items of varied geometry with aspect-ratio
    grouping, frames rendered on both sides: batches equal to the JAX
    Loader's, the last one filled by a wrap-around row marked pad."""
    jcfg = _loader_cfg(tmp_path, ["DATASET.NAME", dataset,
                                  "DATALOADER.ASPECT_RATIO_GROUPING", "true", *opts])
    pcfg = port_cfg(jcfg)
    jsyn.write_synthetic_cache(str(tmp_path), dataset, "test", n_items=5, n_frames=16,
                               vary_geometry=True)
    jds, pds = jsyn.SyntheticDataset(jcfg, "test"), psyn.SyntheticDataset(pcfg, "test")
    pbatches = list(PLoader(pcfg, pds, global_batch=2, is_train=False))
    _assert_same_batches(pbatches, list(JLoader(jcfg, jds, global_batch=2, is_train=False)))
    assert [m["pad"] for _, _, meta in pbatches for m in meta] == [False] * 5 + [True]
    assert pds.decode_routes.counts()["rendered"] == 5


def test_scan_and_precompile_refuse_the_host_path(tmp_path):
    """Signatures are a raw-path notion: the host path's loader cannot scan
    and cli.precompile refuses TPU.DEVICE_PREPROCESS false, as the JAX
    tools do; a yuv420 scan keys its signatures by layout, as JAX's does."""
    from stcat_tpu_torch.cli import precompile

    jsyn.write_synthetic_cache(str(tmp_path), "VidSTG", "train", n_items=3, n_frames=12)
    pcfg = port_cfg(_loader_cfg(tmp_path, HOST))
    with pytest.raises(ValueError, match="DEVICE_PREPROCESS"):
        PLoader(pcfg, psyn.SyntheticDataset(pcfg, "train"), 2, True).scan_signatures()
    with pytest.raises(SystemExit, match="DEVICE_PREPROCESS"):
        precompile.main(["--device", "cpu", "--synthetic", "--list", *HOST])
    jcfg = _loader_cfg(tmp_path, YUV)
    ours = PLoader(port_cfg(jcfg), psyn.SyntheticDataset(port_cfg(jcfg), "train"), 2,
                   True).scan_signatures(2)
    theirs = JLoader(jcfg, jsyn.SyntheticDataset(jcfg, "train"), 2, True).scan_signatures(2)
    assert list(ours) == list(theirs) and {s[-1] for s in ours} == {"yuv420"}


# --------------------------------------------------------------------------
# do_eval and train() against the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [HOST, YUV], ids=["host", "yuv420"])
def test_do_eval_matches_jax(tmp_path, opts):
    """do_eval of the tiny model over 5 synthetic test items of 15 frames
    (JPEG corpus, batches of 2 ending in a wrap-around row, the device
    split) on host-path or yuv420 batches, against JAX do_eval with the
    same weights: boxes at atol 2e-4 px / rtol 1e-3, spans equal, metrics
    at atol 1e-4 (tests/test_torch_eval.py's tolerances)."""
    from stcat_tpu.core.mesh import make_mesh
    from stcat_tpu.eval import build_evaluator as jbuild_evaluator
    from stcat_tpu.eval.engine import do_eval as jdo_eval
    from stcat_tpu.models import STCATNet as JNet
    from stcat_tpu.train.step import make_eval_forward as jmake_fwd

    from stcat_tpu_torch.eval.engine import do_eval
    from stcat_tpu_torch.eval.evaluator import build_evaluator
    from stcat_tpu_torch.models import build_model

    jcfg = tiny_cfg(NO_DROPOUT + ["DATA_DIR", str(tmp_path), "INPUT.RESOLUTION", 64,
                                  "INPUT.SAMPLE_FPS", 2, "INPUT.MAX_QUERY_LEN", 12,
                                  "TPU.FRAME_BUCKETS", "[16]", "TPU.MESH_DATA", 1,
                                  "MODEL.STCAT.ENC_LAYERS", 1, "MODEL.TEXT_MODEL.LAYERS", 1,
                                  "DATALOADER.NUM_WORKERS", 1, *opts])
    cfg = port_cfg(jcfg)
    jsyn.write_synthetic_cache(str(tmp_path), "VidSTG", "test", n_items=5, n_frames=15)
    jsyn.materialize_frame_corpus(str(tmp_path), "VidSTG", "test")
    model = build_model(cfg, device="cpu", seed=3)
    params, consts = jax_variables(model, jcfg)
    mesh = make_mesh(1)
    jev, jmodel = jbuild_evaluator(jcfg, None, "test"), JNet(jcfg)
    jmetrics = jdo_eval(jcfg, jmodel, params, consts,
                        JLoader(jcfg, jsyn.SyntheticDataset(jcfg, "test"), 2, False), jev,
                        jmake_fwd(jcfg, jmodel, mesh), mesh=mesh)
    ds = psyn.SyntheticDataset(cfg, "test")
    ev = build_evaluator(cfg)
    metrics = do_eval(cfg, model, PLoader(cfg, ds, global_batch=2, is_train=False), ev)
    assert ds.decode_routes.counts()[JPEG_ROUTE] == 5
    assert sorted(ev.predictions) == sorted(jev.predictions) == list(range(5))
    for vid, frames in jev.predictions.items():
        assert sorted(ev.predictions[vid]) == sorted(frames), vid
        for fid, box in frames.items():
            np.testing.assert_allclose(ev.predictions[vid][fid], box, atol=2e-4, rtol=1e-3,
                                       err_msg=f"{vid}/{fid}")
        assert ev.video_predictions[vid] == jev.video_predictions[vid], vid
    assert metrics.keys() == jmetrics.keys()
    for k in metrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], atol=1e-4, rtol=0, err_msg=k)


SGD_LRS = [k for g in ("BASE", "TEMP", "TEXT", "VIS_BACKBONE") for k in (f"SOLVER.{g}_LR", 0.5)]


@pytest.mark.parametrize("opts", [HOST, YUV], ids=["host", "yuv420"])
def test_train_matches_jax_train(tmp_path, opts):
    """train() for 3 iterations from a reference .pth MODEL.WEIGHT, every
    dropout 0, SGD, on host-path or yuv420 batches of the JPEG corpus
    (decoded natively on both sides), against the JAX package's train()
    from the same file: parameters and EMA at atol 2e-4 / rtol 1e-3
    (tests/test_torch_slice.py's tolerance). The parameters move by far
    more than that."""
    from stcat_tpu.core.logging import setup_logger as jlogger
    from stcat_tpu.data.synthetic import make_synthetic_dataset as jsynthetic
    from stcat_tpu.train.loop import train as jtrain
    from test_torch_loop import _loop_cfg

    from stcat_tpu_torch.convert import from_jax_variables
    from stcat_tpu_torch.models import build_model
    from stcat_tpu_torch.train import loop as ploop

    weight = str(tmp_path / "init.pth")
    jcfg = _loop_cfg(tmp_path, "jax", ["MODEL.WEIGHT", weight, "TPU.MESH_DATA", 1,
                                       "SOLVER.OPTIMIZER", "sgd", *SGD_LRS, *opts])
    cfg = port_cfg(merge_from_list(jcfg, ["OUTPUT_DIR", str(tmp_path / "port")]))
    init = build_model(cfg, device="cpu", seed=7).state_dict()
    torch.save(init, weight)
    datasets = []

    def make_dataset(c, split):
        datasets.append(psyn.make_synthetic_dataset(c, split, n_items=4, n_frames=12))
        return datasets[-1]

    state, it = ploop.train(cfg, make_dataset, max_iters=3, device="cpu")
    assert it == state.step == 3
    routes = datasets[0].decode_routes.counts()  # the loader decodes ahead of the steps
    assert routes[JPEG_ROUTE] >= 3 * 2 and sum(routes.values()) == routes[JPEG_ROUTE]
    jstate, jit = jtrain(jcfg, lambda c, split: jsynthetic(c, split, n_items=4, n_frames=12),
                         logger=jlogger("jax-loop", rank=0), max_iters=3)
    assert jit == 3 and int(jstate.step) == 3
    consts = jax.tree_util.tree_map(np.asarray, jstate.constants)
    want_p = from_jax_variables(jax.tree_util.tree_map(np.asarray, jstate.params), consts)
    want_e = from_jax_variables(jax.tree_util.tree_map(np.asarray, jstate.ema_params), consts)
    moved = 0.0
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(), atol=2e-4,
                                   rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(), want_e[name].numpy(), atol=2e-4,
                                   rtol=1e-3, err_msg=name)
        moved = max(moved, (p.detach() - init[name]).abs().max().item())
    assert moved > 50 * 2e-4


@pytest.mark.parametrize("opts", [HOST, YUV], ids=["host", "yuv420"])
def test_cli_train_trains_and_evaluates(tmp_path, opts):
    """python -m stcat_tpu_torch.cli.train --synthetic --device cpu with the
    host pixel path or the yuv420 ingest: 2 iterations with validation at
    1, metrics and validation written."""
    out = tmp_path / "out"
    tiny = ["MODEL.VISION_BACKBONE.DEPTHS", "[1,1,1,1]", "MODEL.STCAT.HIDDEN", "64",
            "MODEL.STCAT.HEADS", "4", "MODEL.STCAT.FFN_DIM", "128", "MODEL.STCAT.ENC_LAYERS", "1",
            "MODEL.STCAT.DEC_LAYERS", "2", "MODEL.TEXT_MODEL.VOCAB_SIZE", "128",
            "MODEL.TEXT_MODEL.HIDDEN", "32", "MODEL.TEXT_MODEL.LAYERS", "1",
            "MODEL.TEXT_MODEL.HEADS", "2", "MODEL.TEXT_MODEL.INTERMEDIATE", "64",
            "MODEL.TEXT_MODEL.MAX_POS", "64", "INPUT.MAX_VIDEO_LEN", "32",
            "TPU.COMPUTE_DTYPE", "float32", "INPUT.RESOLUTION", "64",
            "INPUT.TRAIN_SAMPLE_NUM", "4", "INPUT.MAX_QUERY_LEN", "12", "DATA_TRUNK", "2",
            "TPU.FRAME_BUCKETS", "[4,8]", "SOLVER.VAL_PERIOD", "1",
            "SOLVER.CHECKPOINT_PERIOD", "5", "DATALOADER.NUM_WORKERS", "1",
            "DATA_DIR", str(tmp_path / "data"), "OUTPUT_DIR", str(out)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=str(torch.get_num_threads()))
    res = subprocess.run([sys.executable, "-m", "stcat_tpu_torch.cli.train", "--synthetic",
                          "--device", "cpu", "--max-iters", "2", *tiny, *opts],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [2] and np.isfinite(rows[0]["loss"])
    with open(out / "validation.jsonl") as f:
        val = [json.loads(line) for line in f]
    assert [v["step"] for v in val] == [1]
    assert all(0.0 <= v <= 1.0 for k, v in val[0].items() if k.endswith(("tiou", "viou")))
