"""The port's batch-shape scan and precompile CLI against the JAX package's,
on the CPU (tests/test_precompile.py's cases).

A plan-only sample must equal the real sample drawn from the same generator
but for its zero pixels; ``raw_batch_signature`` and
``Loader.scan_signatures`` must give the JAX Loader's signatures and
exemplars on the same synthetic cache (train over two reshuffled epochs;
eval with wrap-around rows, and with a batch of wrap-around rows only), and
every batch the port's iterator emits must hit a scanned signature. Then the
CLI: ``--list``, a run of every signature in both TPU.EVAL_DEVICE_SPLIT
variants, and the schedule horizon it hands the optimizer.
"""

import dataclasses

import numpy as np
import pytest

from helpers import tiny_cfg
from stcat_tpu.data import synthetic as jsyn
from stcat_tpu.data.batching import raw_batch_signature as jsignature
from stcat_tpu.data.loader import Loader as JLoader
from test_torch_train import port_cfg

from stcat_tpu_torch.cli import precompile as pprecompile
from stcat_tpu_torch.data import synthetic as psyn
from stcat_tpu_torch.data.batching import raw_batch_signature
from stcat_tpu_torch.data.loader import Loader


def _cfg(tmp_path, extra=()):
    """tests/test_precompile.py's: multi-scale on, crop off, two buckets."""
    return tiny_cfg(["DATA_DIR", str(tmp_path), "INPUT.RESOLUTION", 64,
                     "INPUT.TRAIN_SAMPLE_NUM", 8, "INPUT.MAX_QUERY_LEN", 12,
                     "INPUT.AUG_SCALE", "true", "INPUT.AUG_CROP", "false",
                     "TPU.FRAME_BUCKETS", "[8,16]", "DATALOADER.NUM_WORKERS", 0, *extra])


def _same_sample(a, b):
    """Two raw samples (port and JAX, or plan-only and decoded) alike but
    for their pixel values."""
    assert a["frames_u8"].shape == b["frames_u8"].shape and a["frames_u8"].dtype == np.uint8
    assert dataclasses.asdict(a["plan"]) == dataclasses.asdict(b["plan"])
    for k in ("boxes", "boxes_cxcywh", "actioness"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("text", "item_id", "frame_ids", "ori_size", "qtype"):
        assert a[k] == b[k], k
    assert a.get("pad", False) == b.get("pad", False)


def _batch_signature(batch):
    return (batch.frames_u8.shape[0], batch.frames_u8.shape[1],
            tuple(batch.frames_u8.shape[2:4]), batch.out_canvas, "rgb")


def test_plan_only_sample_matches_decoded_and_jax(tmp_path):
    jcfg = _cfg(tmp_path)
    jsyn.write_synthetic_cache(str(tmp_path), "VidSTG", "train", n_items=3, n_frames=12)
    pds, jds = psyn.SyntheticDataset(port_cfg(jcfg), "train"), jsyn.SyntheticDataset(jcfg, "train")
    for idx in range(3):
        real = pds.__getitem__(idx, rng=np.random.default_rng(7 + idx))
        plan = pds.__getitem__(idx, rng=np.random.default_rng(7 + idx), plan_only=True)
        theirs = jds.__getitem__(idx, rng=np.random.default_rng(7 + idx), plan_only=True)
        assert not plan["frames_u8"].any() and real["frames_u8"].any()
        _same_sample(plan, real)
        _same_sample(plan, theirs)


def test_train_scan_matches_jax_over_two_epochs(tmp_path):
    """Signatures (several output canvases from the scale draws), exemplars
    and raw_batch_signature equal the JAX Loader's; every batch of the
    port's iterator over the same two epochs has a scanned signature, and
    an exemplar builds a batch of its signature."""
    jcfg = _cfg(tmp_path)
    jsyn.write_synthetic_cache(str(tmp_path), "VidSTG", "train", n_items=4, n_frames=12)
    pcfg = port_cfg(jcfg)
    ploader = Loader(pcfg, psyn.SyntheticDataset(pcfg, "train"), global_batch=2, is_train=True)
    jloader = JLoader(jcfg, jsyn.SyntheticDataset(jcfg, "train"), global_batch=2, is_train=True)
    ours, theirs = ploader.scan_signatures(2), jloader.scan_signatures(2)
    assert list(ours) == list(theirs) and len(ours) > 1
    buckets = pcfg.TPU.FRAME_BUCKETS
    for sig, samples in ours.items():
        assert raw_batch_signature(samples, buckets) == jsignature(theirs[sig], buckets) == sig
        for a, b in zip(samples, theirs[sig]):
            _same_sample(a, b)
        assert _batch_signature(ploader._make_batch(samples)[0]) == sig
    it = iter(Loader(pcfg, psyn.SyntheticDataset(pcfg, "train"), global_batch=2, is_train=True))
    for _ in range(2 * ploader.iters_per_epoch):
        assert _batch_signature(next(it)[0]) in ours


@pytest.mark.parametrize("n_items, batch, vary", [
    (3, 1, False),   # one clip per batch
    (5, 2, True),    # the last batch ends in a wrap-around row; mixed geometry
    (3, 4, False),   # one batch of 3 real rows and a wrap-around row
    (1, 3, True),    # the one item and two wrap-around rows
])
def test_eval_scan_matches_jax_and_the_iterator(tmp_path, n_items, batch, vary):
    """Eval scans one pass; wrap-around rows reuse the batch's first real
    sample as the iterator's do, so the scanned set is the JAX Loader's and
    the port iterator's, pads included."""
    jcfg = _cfg(tmp_path)
    jsyn.write_synthetic_cache(str(tmp_path), "VidSTG", "test", n_items=n_items, n_frames=12,
                               vary_geometry=vary)
    pcfg = port_cfg(jcfg)
    ours = Loader(pcfg, psyn.SyntheticDataset(pcfg, "test"), global_batch=batch,
                  is_train=False).scan_signatures()
    theirs = JLoader(jcfg, jsyn.SyntheticDataset(jcfg, "test"), global_batch=batch,
                     is_train=False).scan_signatures()
    assert list(ours) == list(theirs)
    for sig, samples in ours.items():
        for a, b in zip(samples, theirs[sig]):
            _same_sample(a, b)
    real = {_batch_signature(b) for b, _, _ in
            Loader(pcfg, psyn.SyntheticDataset(pcfg, "test"), global_batch=batch, is_train=False)}
    assert real == set(ours)


def test_precompile_cli_lists_then_runs_each_signature(tmp_path, monkeypatch):
    """--list scans and runs nothing; a run takes each train signature
    through one step with the schedule horizon train() derives (clamped by
    --max-iters) and each eval signature through the eval forward, in both
    TPU.EVAL_DEVICE_SPLIT variants."""
    from test_cli import TINY_OPTS

    from stcat_tpu_torch.cli import load_config
    from stcat_tpu_torch.train import optimizer as popt

    psyn.write_synthetic_cache(str(tmp_path), "VidSTG", "train", n_items=3, n_frames=12)
    psyn.write_synthetic_cache(str(tmp_path), "VidSTG", "test", n_items=2, n_frames=12)
    cfg_opts = TINY_OPTS + ["DATA_DIR", str(tmp_path), "OUTPUT_DIR", str(tmp_path / "out"),
                            "INPUT.TRAIN_SAMPLE_NUM", "8", "INPUT.AUG_SCALE", "true",
                            "INPUT.AUG_CROP", "false", "TPU.FRAME_BUCKETS", "[8,16]",
                            "SOLVER.MAX_EPOCH", "7", "DATALOADER.NUM_WORKERS", "0"]
    args = ["--synthetic", "--device", "cpu", "--epochs", "1"]
    assert pprecompile.main(args + ["--list"] + cfg_opts) == []

    horizons = []
    real = popt.make_optimizer
    monkeypatch.setattr(popt, "make_optimizer",
                        lambda cfg, model, n: horizons.append(n) or real(cfg, model, n))
    cfg = load_config("", cfg_opts)
    iters = Loader(cfg, psyn.SyntheticDataset(cfg, "train"), global_batch=1,
                   is_train=True).iters_per_epoch
    for split in ("true", "false"):
        records = pprecompile.main(args + cfg_opts + ["TPU.EVAL_DEVICE_SPLIT", split])
        modes = [r["mode"] for r in records]
        assert modes.count("train") >= 1 and modes.count("eval") >= 1
        assert all(r["seconds"] > 0 and r["peak_gb"] is None for r in records)
    assert pprecompile.main(args + ["--mode", "train", "--max-iters", "5"] + cfg_opts)
    assert horizons == [7 * iters, 7 * iters, 5]
