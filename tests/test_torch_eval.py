"""The port's evaluation against the JAX package's, on the CPU.

``GroundingEvaluator`` on identical predictions for both benchmarks, and a
whole ``do_eval`` pass of the tiny model (tests/test_torch_train.py's
config) over a synthetic test split, with the weights handed to JAX through
``convert_reference_stcat``: the port's pass in both TPU.EVAL_DEVICE_SPLIT
variants against one JAX pass. Tolerances are stated at each comparison.
"""

import dataclasses

import numpy as np
import pytest

from helpers import tiny_cfg
from stcat_tpu.config import merge_from_list
from stcat_tpu.data import synthetic as jsyn
from stcat_tpu.eval import build_evaluator as jbuild_evaluator
from test_torch_train import NO_DROPOUT, jax_variables, port_cfg

from stcat_tpu_torch.core.batch import stack_streams, subsample_stream, to_device
from stcat_tpu_torch.data.loader import Loader
from stcat_tpu_torch.data.synthetic import SyntheticDataset
from stcat_tpu_torch.eval.engine import do_eval
from stcat_tpu_torch.eval.evaluator import build_evaluator
from stcat_tpu_torch.models import build_model
from stcat_tpu_torch.train.step import make_eval_forward


def _cfg(tmp_path, dataset, extra=()):
    return tiny_cfg(NO_DROPOUT + ["DATA_DIR", str(tmp_path), "DATASET.NAME", dataset,
                                  "INPUT.RESOLUTION", 64, "INPUT.TRAIN_SAMPLE_NUM", 8,
                                  "INPUT.SAMPLE_FPS", 2, "INPUT.MAX_QUERY_LEN", 12,
                                  "TPU.FRAME_BUCKETS", "[16]", "TPU.MESH_DATA", 1,
                                  "MODEL.STCAT.ENC_LAYERS", 1, "MODEL.TEXT_MODEL.LAYERS", 1,
                                  "DATALOADER.NUM_WORKERS", 1, *extra])


@pytest.mark.parametrize("dataset", ["VidSTG", "HC-STVG"])
def test_evaluator_matches_jax(tmp_path, dataset):
    """Seeded box and span predictions for every test item (a few spans
    disjoint from the GT, a few boxes degenerate) into both evaluators:
    the same summary (VidSTG per question type, HC-STVG overall) and the
    same per-item results, exactly."""
    jsyn.write_synthetic_cache(str(tmp_path), dataset, "test", n_items=7, n_frames=20,
                               vary_geometry=True)
    jcfg = _cfg(tmp_path, dataset)
    ours, theirs = build_evaluator(port_cfg(jcfg)), jbuild_evaluator(jcfg, None, "test")
    rng = np.random.default_rng(4)
    for vid, boxes in ours.vid2box.items():
        n = ours.vid2steds[vid][1] + 6
        s = int(rng.integers(0, n - 2))
        e = int(rng.integers(s + 1, n))
        pred = {}
        for fid in range(n):
            x0, y0 = rng.uniform(0, 40, 2)
            w, h = rng.uniform(0, 30, 2) * (fid % 5 != 0)
            pred[fid] = [[float(x0), float(y0), float(x0 + w), float(y0 + h)]]
        for ev in (ours, theirs):
            ev.update({vid: dict(pred)})
            ev.video_update({vid: {"sted": [s, e], "qtype": "declar" if vid % 2 else "inter"}})
    a, b = ours.summarize(), theirs.summarize()
    assert a == b and len(a) == (14 if dataset == "VidSTG" else 7)
    assert ours.results == theirs.results


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """The synthetic test split (5 items of 15 frames, so the two streams
    differ in length and batches of 2 end in a wrap-around row), the port
    model's weights and the JAX do_eval's predictions and metrics."""
    from stcat_tpu.core.mesh import make_mesh
    from stcat_tpu.data.loader import Loader as JLoader
    from stcat_tpu.eval.engine import do_eval as jdo_eval
    from stcat_tpu.models import STCATNet as JNet
    from stcat_tpu.train.step import make_eval_forward as jmake_fwd

    tmp = tmp_path_factory.mktemp("eval")
    jcfg = _cfg(tmp, "VidSTG")
    jsyn.write_synthetic_cache(str(tmp), "VidSTG", "test", n_items=5, n_frames=15)
    model = build_model(port_cfg(jcfg), device="cpu", seed=3)
    params, consts = jax_variables(model, jcfg)
    jloader = JLoader(jcfg, jsyn.SyntheticDataset(jcfg, "test"), global_batch=2, is_train=False)
    mesh = make_mesh(1)
    jev = jbuild_evaluator(jcfg, None, "test")
    jmodel = JNet(jcfg)
    metrics = jdo_eval(jcfg, jmodel, params, consts, jloader, jev,
                       jmake_fwd(jcfg, jmodel, mesh), mesh=mesh)
    return jcfg, model.state_dict(), jev, metrics


@pytest.mark.parametrize("device_split", [True, False])
def test_do_eval_matches_jax(eval_setup, device_split):
    """The port's do_eval (the stacked two-stream forward, split on the
    device or stacked on the host, postprocess, the stream merge and the
    evaluator) against JAX do_eval with the same weights: every frame's box
    at atol 2e-4 px / rtol 1e-3, spans equal, metrics at atol 1e-4 (they
    follow from the boxes). Each item is predicted once: the wrap-around
    row is skipped."""
    jcfg, sd, jev, jmetrics = eval_setup
    cfg = port_cfg(merge_from_list(jcfg, ["TPU.EVAL_DEVICE_SPLIT", str(device_split).lower()]))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    loader = Loader(cfg, SyntheticDataset(cfg, "test"), global_batch=2, is_train=False)
    ev = build_evaluator(cfg)
    metrics = do_eval(cfg, model, loader, ev)

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


def test_device_split_forward_equals_the_host_split(eval_setup):
    """make_eval_forward with the device split (the batch crosses whole and
    is split into its even and odd streams in torch) equals the forward of
    the host-stacked batch, bitwise, at an odd frame count."""
    jcfg, sd, _, _ = eval_setup
    cfg = port_cfg(jcfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    loader = Loader(cfg, SyntheticDataset(cfg, "test"), global_batch=2, is_train=False)
    raw, _, _ = next(iter(loader))
    raw = dataclasses.replace(raw, frames_u8=raw.frames_u8[:, :15],
                              frame_valid=raw.frame_valid[:, :15])
    dev = make_eval_forward(cfg, model, device_split=True)(to_device(raw, "cpu"))
    stacked = stack_streams(subsample_stream(raw, 0), subsample_stream(raw, 1))
    host = make_eval_forward(cfg, model, device_split=False)(to_device(stacked, "cpu"))
    assert dev["frame_valid"].shape == (4, 8)
    np.testing.assert_array_equal(dev["frame_valid"].numpy(), stacked.frame_valid)
    for k in ("pred_boxes", "pred_sted"):
        assert np.array_equal(dev[k].numpy(), host[k].numpy()), k
