"""The port's data path against the JAX package's, on the CPU.

The cache writers (synthetic and the two benchmarks' raw-annotation
builders), the clip samplers, the train transform plan and the whole loader:
the same seeded inputs through ``stcat_tpu.data`` and ``stcat_tpu_torch.data``
must give equal results. Everything here is host numpy, so every comparison
is exact; pixels too, because both sides render the synthetic frames or both
decode the JPEG corpus through PIL.
"""

import dataclasses
import gzip
import json
import os

import numpy as np
import pytest

from helpers import tiny_cfg
from stcat_tpu.config import merge_from_list
from stcat_tpu.data import annotations as jann, sampling as jsamp, synthetic as jsyn
from stcat_tpu.data import transforms as jtf
from stcat_tpu.data.loader import Loader as JLoader
from test_torch_train import port_cfg

from stcat_tpu_torch.data import annotations as pann, sampling as psamp, synthetic as psyn
from stcat_tpu_torch.data import transforms as ptf
from stcat_tpu_torch.data.datasets import build_dataset
from stcat_tpu_torch.data.loader import Loader as PLoader, make_loader


def _cache_text(data_dir, dataset, split):
    """The decompressed bytes of a split's two cache files (gzip's header
    carries the write time, so the compressed files differ by it)."""
    out = []
    for path in pann.cache_paths(data_dir, dataset, split):
        with gzip.open(path, "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("dataset,split,kw", [
    ("VidSTG", "train", {}),
    ("VidSTG", "test", {"vary_geometry": True}),
    ("HC-STVG", "train", {"shared_span": True, "n_items": 5, "n_frames": 7}),
])
def test_write_synthetic_cache_matches_jax(tmp_path, dataset, split, kw):
    """The same arguments write the same cache: equal json bytes."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jsyn.write_synthetic_cache(jdir, dataset, split, seed=3, **kw)
    psyn.write_synthetic_cache(pdir, dataset, split, seed=3, **kw)
    assert _cache_text(jdir, dataset, split) == _cache_text(pdir, dataset, split)
    item = psyn._load(pann.cache_paths(pdir, dataset, split)[0])[1]
    np.testing.assert_array_equal(psyn.render_frames(item, [0, 3, 5]),
                                  jsyn.render_frames(item, [0, 3, 5]))


def _raw_vidstg(root):
    """Raw VidSTG annotations for three videos, a caption and a question
    each: the second video's span lies outside its used segment (both pairs
    dropped), the first one's question target has a trajectory hole
    (dropped); the captions carry typos from the published table."""
    os.makedirs(os.path.join(root, "sent_annos"))
    os.makedirs(os.path.join(root, "bbox_annos"))
    annos = []
    for v, (seg, tgt) in enumerate([((2, 14), (4, 9)), ((0, 11), (13, 15)),
                                     ((0, 15), (3, 12))]):
        vid = f"v{v}"
        frame_count = 16
        traj = []
        for f in range(frame_count):
            boxes = [{"tid": 0, "bbox": {"xmin": f, "ymin": 2, "xmax": f + 20, "ymax": 30}}]
            if not (v == 0 and f == 6):  # a hole in object 1's trajectory
                boxes.append({"tid": 1, "bbox": {"xmin": 5, "ymin": f, "xmax": 40,
                                                 "ymax": f + 10}})
            traj.append(boxes)
        with open(os.path.join(root, "bbox_annos", vid + ".json"), "w") as fh:
            json.dump({"trajectories": traj}, fh)
        annos.append({
            "vid": vid, "fps": 25, "frame_count": frame_count, "width": 64, "height": 48,
            "used_segment": {"begin_fid": seg[0], "end_fid": seg[1]},
            "temporal_gt": {"begin_fid": tgt[0], "end_fid": tgt[1]},
            "subject/objects": [{"tid": 0, "category": "adult"}, {"tid": 1, "category": "dog"}],
            "captions": [{"target_id": 0, "description": "An adult aborad the boat, abvoe!"}],
            "questions": [{"target_id": 1, "description": "What is the dog doing?"}],
        })
    with open(os.path.join(root, "sent_annos", "train_annotations.json"), "w") as fh:
        json.dump(annos, fh)


def _raw_hcstvg(root):
    os.makedirs(os.path.join(root, "annos", "hcstvg_v1"))
    raw = {}
    for i, vid in enumerate(["a.mp4", "1_aMYcLyh9OhU.mkv", "b.mp4", "c.mp4"]):
        raw[vid] = {"img_num": 30 + i, "st_frame": 3 + i, "width": 80, "height": 60,
                    "bbox": [[i, 2, 20, 30 + k] for k in range(10 + i)],
                    "caption": f"The man in the red shirt turns {'left' if i % 2 else 'right'}."}
    with open(os.path.join(root, "annos", "hcstvg_v1", "train.json"), "w") as fh:
        json.dump(raw, fh)


@pytest.mark.parametrize("dataset,writer", [("VidSTG", _raw_vidstg), ("HC-STVG", _raw_hcstvg)])
def test_benchmark_cache_builders_match_jax(tmp_path, dataset, writer):
    """Raw benchmark annotations through each package's load_or_build_cache:
    the same items and annotations (spoiled pairs dropped, the known-missing
    HC-STVG video skipped, typos fixed, the seeded item order) and the same
    cache bytes."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, pdir):
        writer(str(d))
    jitems, jannos = jann.load_or_build_cache(str(jdir), dataset, "train", seed=5)
    pitems, pannos = pann.load_or_build_cache(str(pdir), dataset, "train", seed=5)
    assert pitems == jitems and pannos == jannos
    assert len(pitems) == 3  # VidSTG: 3 of 6 pairs; HC-STVG: 3 of 4 videos
    assert _cache_text(str(jdir), dataset, "train") == _cache_text(str(pdir), dataset, "train")
    if dataset == "VidSTG":
        assert "aboard" in " ".join(it["description"] for it in pitems)


def _sampling_cfg(dataset, extra=()):
    return tiny_cfg(["DATASET.NAME", dataset, "INPUT.TRAIN_SAMPLE_NUM", 6,
                     "INPUT.SAMPLE_FPS", 3, "INPUT.TEMP_CROP_PROB", 0.5, *extra])


@pytest.mark.parametrize("dataset", ["VidSTG", "HC-STVG"])
def test_clip_sampling_matches_jax(tmp_path, dataset):
    """make_*_input_clip on every synthetic item, train (temporal crop drawn
    from the generator) and test, over 20 seeds: the same frame ids,
    actioness, heatmaps and the same GT boxes."""
    jcfg = _sampling_cfg(dataset)
    pcfg = port_cfg(jcfg)
    psyn.write_synthetic_cache(str(tmp_path), dataset, "train", n_items=4, n_frames=40,
                               vary_geometry=True)
    items = psyn._load(pann.cache_paths(str(tmp_path), dataset, "train")[0])
    pfn = psamp.make_vidstg_input_clip if dataset == "VidSTG" else psamp.make_hcstvg_input_clip
    jfn = jsamp.make_vidstg_input_clip if dataset == "VidSTG" else jsamp.make_hcstvg_input_clip
    for split in ("train", "test"):
        for seed in range(20):
            for item in items:
                a = pfn(pcfg, split, dict(item), np.random.default_rng(seed))
                b = jfn(jcfg, split, dict(item), np.random.default_rng(seed))
                assert a["frame_ids"] == b["frame_ids"], (split, seed)
                for key in ("actioness", "start_heatmap", "end_heatmap"):
                    np.testing.assert_array_equal(a[key], b[key])
                np.testing.assert_array_equal(psamp.gt_box_alignment(a),
                                              jsamp.gt_box_alignment(b))


def test_train_plan_matches_jax():
    """The train transform (hflip with the left/right word swap, then
    RandomSelect of a multi-scale resize or resize -> RandomSizeCrop ->
    resize) over 60 generator seeds and three source geometries: the same
    plan (flip, ops, output size, affine map), boxes and text, and the same
    generator state afterwards. Every branch is taken."""
    jcfg = tiny_cfg(["INPUT.RESOLUTION", 320])
    pt, jt = ptf.build_transforms(port_cfg(jcfg), is_train=True), jtf.build_transforms(jcfg, True)
    seen = set()
    for hw in ((240, 320), (720, 1280), (640, 480)):
        boxes = np.asarray([[10, 20, 100, 120], [50, 60, 200, 230]], np.float32)
        for seed in range(60):
            rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
            p_plan, p_boxes, p_text = pt.plan(hw, boxes, "the left dog walks right", rp)
            j_plan, j_boxes, j_text = jt.plan(hw, boxes, "the left dog walks right", rj)
            assert dataclasses.asdict(p_plan) == dataclasses.asdict(j_plan), (hw, seed)
            np.testing.assert_array_equal(p_boxes, j_boxes)
            assert p_text == j_text
            assert rp.random() == rj.random()
            seen.add((p_plan.flip, any(op[0] == "crop" for op in p_plan.ops)))
    assert seen == {(False, False), (False, True), (True, False), (True, True)}
    # the eval plan needs no generator and draws nothing
    ev = ptf.build_transforms(port_cfg(jcfg))
    plan, _, text = ev.plan((240, 320), np.zeros((0, 4), np.float32), "left")
    assert not plan.flip and text == "left" and plan.out_hw == (320, 426)
    with pytest.raises(ValueError, match="Generator"):
        pt.plan((240, 320), boxes, "x")


def _assert_same_batches(port_batches, jax_batches):
    assert len(port_batches) == len(jax_batches)
    for (pb, pt, pm), (jb, jt, jm) in zip(port_batches, jax_batches):
        for f in dataclasses.fields(pb):
            a, b = getattr(pb, f.name), getattr(jb, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == np.asarray(b).dtype, f.name
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
            else:
                assert a == b, f.name
        assert jb.frames_y is None and jb.frames_cbcr is None
        for f in dataclasses.fields(pt):
            np.testing.assert_array_equal(getattr(pt, f.name), np.asarray(getattr(jt, f.name)),
                                          err_msg=f.name)
        assert pm == jm


def _loader_cfg(tmp_path, dataset, extra=()):
    return tiny_cfg(["DATA_DIR", str(tmp_path), "DATASET.NAME", dataset,
                     "INPUT.RESOLUTION", 64, "INPUT.TRAIN_SAMPLE_NUM", 8,
                     "INPUT.SAMPLE_FPS", 2, "INPUT.MAX_QUERY_LEN", 12,
                     "TPU.FRAME_BUCKETS", "[8,16,32,64]", "SOLVER.MAX_EPOCH", 2,
                     "DATALOADER.NUM_WORKERS", 2, "SEED", 11, *extra])


@pytest.mark.parametrize("materialized", [False, True])
def test_train_loader_matches_jax_with_resume(tmp_path, monkeypatch, materialized):
    """The train loader over two epochs (reshuffled per epoch, train plans
    and temporal crops drawn from the per-(iteration, index) generator, 7
    items in batches of 2, so each epoch ends in a wrap-around row): the raw
    batches, targets and meta equal the JAX Loader's, field for field; a
    loader resumed at start_iter 3 gives the uninterrupted run's batches
    from the fourth on. Frames are rendered, or decoded from the JPEG corpus:
    by the port's native libjpeg decoder and by PIL on the JAX side (its
    native decoder turned off here), which give the same pixels."""
    jcfg = _loader_cfg(tmp_path, "VidSTG")
    pcfg = port_cfg(jcfg)
    jsyn.write_synthetic_cache(str(tmp_path), "VidSTG", "train", n_items=7, n_frames=20)
    if materialized:
        import stcat_tpu.data.jpeg_decode as jjpeg

        monkeypatch.setattr(jjpeg, "decode_jpeg_batch", lambda *a, **k: None)
        assert jsyn.materialize_frame_corpus(str(tmp_path), "VidSTG", "train") == 7 * 20
    jds, pds = jsyn.SyntheticDataset(jcfg, "train"), psyn.SyntheticDataset(pcfg, "train")
    jl = JLoader(jcfg, jds, global_batch=2, is_train=True)
    pl = make_loader(pcfg, pds, "train")
    assert pl.global_batch == pcfg.SOLVER.BATCH_SIZE == 1
    pl = PLoader(pcfg, pds, global_batch=2, is_train=True)
    assert pl.iters_per_epoch == jl.iters_per_epoch == 4
    jbatches, pbatches = list(jl), list(pl)
    assert len(pbatches) == 8
    _assert_same_batches(pbatches, jbatches)
    resumed = list(PLoader(pcfg, pds, global_batch=2, is_train=True, start_iter=3))
    _assert_same_batches(resumed, jbatches[3:])
    flips = [bool(f) for b, _, _ in pbatches for f in b.flip]
    assert any(flips) and not all(flips)


def test_batch_pool_crosses_epochs_like_one_worker(tmp_path):
    """PREFETCH_DEPTH 3 over 4 reshuffled epochs of 2 batches each (so the
    batch-pool threads build batches of two epochs at once): the same raw
    batches, targets and meta as a PREFETCH_DEPTH 1 run."""
    psyn.write_synthetic_cache(str(tmp_path), "VidSTG", "train", n_items=3, n_frames=12)
    runs = []
    for depth in (3, 1):
        cfg = port_cfg(_loader_cfg(tmp_path, "VidSTG", ["DATALOADER.PREFETCH_DEPTH", depth,
                                                        "SOLVER.MAX_EPOCH", 4]))
        runs.append(list(PLoader(cfg, psyn.SyntheticDataset(cfg, "train"), global_batch=2,
                                 is_train=True)))
    deep, shallow = runs
    assert len(deep) == len(shallow) == 8
    for (db, dt, dm), (sb, st, sm) in zip(deep, shallow):
        for a, b in ((db, sb), (dt, st)):
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(x, np.ndarray):
                    np.testing.assert_array_equal(x, y, err_msg=f.name)
                else:
                    assert x == y, f.name
        assert dm == sm
    assert len({tuple(m["item_id"] for m in meta) for _, _, meta in deep}) > 1


def test_make_synthetic_dataset_writes_the_jax_jpeg_corpus(tmp_path):
    """Where PIL can be imported, make_synthetic_dataset writes the JPEG
    corpus, file for file and byte for byte what the JAX package's writes,
    and the dataset then reads its frames from it."""
    pcfg = port_cfg(_loader_cfg(tmp_path / "port", "VidSTG"))
    jcfg = _loader_cfg(tmp_path / "jax", "VidSTG")
    pds = psyn.make_synthetic_dataset(pcfg, "train", n_items=2, n_frames=6)
    jsyn.make_synthetic_dataset(jcfg, "train", n_items=2, n_frames=6)
    pdir, jdir = tmp_path / "port" / "frame", tmp_path / "jax" / "frame"
    files = sorted(p.relative_to(pdir) for p in pdir.rglob("*.jpg"))
    assert files == sorted(p.relative_to(jdir) for p in jdir.rglob("*.jpg"))
    assert len(files) == 2 * 6
    for rel in files:
        assert (pdir / rel).read_bytes() == (jdir / rel).read_bytes(), rel
    item = pds.items[0]
    decoded = pds.load_frames(item)
    rendered = psyn.render_frames(item, item["frame_ids"])
    assert decoded.shape == rendered.shape and not np.array_equal(decoded, rendered)


@pytest.mark.parametrize("dataset", ["VidSTG", "HC-STVG"])
def test_eval_loader_matches_jax_with_pads_and_grouping(tmp_path, dataset):
    """One eval pass over 5 items of varied geometry (portrait and
    landscape, two durations) with aspect-ratio grouping, in batches of 2:
    batches equal to the JAX Loader's, the last one filled by a wrap-around
    row marked meta["pad"], and every batch of one orientation but the
    epoch's tail."""
    jcfg = _loader_cfg(tmp_path, dataset, ["DATALOADER.ASPECT_RATIO_GROUPING", "true"])
    pcfg = port_cfg(jcfg)
    jsyn.write_synthetic_cache(str(tmp_path), dataset, "test", n_items=5, n_frames=16,
                               vary_geometry=True)
    jds, pds = jsyn.SyntheticDataset(jcfg, "test"), psyn.SyntheticDataset(pcfg, "test")
    jbatches = list(JLoader(jcfg, jds, global_batch=2, is_train=False))
    pbatches = list(PLoader(pcfg, pds, global_batch=2, is_train=False))
    _assert_same_batches(pbatches, jbatches)
    pads = [m["pad"] for _, _, meta in pbatches for m in meta]
    assert pads == [False] * 5 + [True]
    ids = [m["item_id"] for _, _, meta in pbatches for m in meta if not m["pad"]]
    assert sorted(ids) == list(range(5))


def test_loader_refuses_what_the_port_does_not_ingest(tmp_path):
    """An ingest layout other than rgb and yuv420 is refused with the JAX
    Loader's message (tests/test_yuv_ingest.py::test_bad_layout_rejected),
    on both sides; the two layouts the port ingests are taken."""
    psyn.write_synthetic_cache(str(tmp_path), "VidSTG", "train", n_items=2)
    jcfg = merge_from_list(_loader_cfg(tmp_path, "VidSTG"), ["TPU.INGEST_LAYOUT", "nv12"])
    cfg = port_cfg(jcfg)
    with pytest.raises(ValueError, match="INGEST_LAYOUT") as port_err:
        make_loader(cfg, psyn.SyntheticDataset(cfg, "train"), "train")
    with pytest.raises(ValueError, match="INGEST_LAYOUT") as jax_err:
        JLoader(jcfg, jsyn.SyntheticDataset(jcfg, "train"), global_batch=1, is_train=True)
    assert str(port_err.value) == str(jax_err.value)
    for layout in ("rgb", "yuv420"):
        cfg = port_cfg(merge_from_list(jcfg, ["TPU.INGEST_LAYOUT", layout]))
        assert make_loader(cfg, psyn.SyntheticDataset(cfg, "train"), "train").raw


def test_build_dataset_reads_the_benchmark_layout(tmp_path, monkeypatch):
    """build_dataset for a benchmark name reads its cache, samples and
    plans like the JAX dataset and takes its frames from DATA_DIR/frame/<vid>
    (the port's native decoder, PIL on the JAX side); another dataset name
    is refused."""
    from stcat_tpu.data.datasets import build_dataset as jbuild
    import stcat_tpu.data.jpeg_decode as jjpeg

    monkeypatch.setattr(jjpeg, "decode_jpeg_batch", lambda *a, **k: None)
    jcfg = _loader_cfg(tmp_path, "VidSTG")
    jsyn.write_synthetic_cache(str(tmp_path), "VidSTG", "train", n_items=3, n_frames=12)
    jsyn.materialize_frame_corpus(str(tmp_path), "VidSTG", "train")
    pds, jds = build_dataset(port_cfg(jcfg), "train"), jbuild(jcfg, "train")
    for i in range(3):
        a = pds.__getitem__(i, rng=np.random.default_rng(i))
        b = jds.__getitem__(i, rng=np.random.default_rng(i), raw=True)
        assert set(a) == set(b)
        for k in a:
            if k == "plan":
                assert dataclasses.asdict(a[k]) == dataclasses.asdict(b[k])
            elif isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    with pytest.raises(ValueError, match="not supported"):
        build_dataset(port_cfg(merge_from_list(jcfg, ["DATASET.NAME", "Other"])), "train")
