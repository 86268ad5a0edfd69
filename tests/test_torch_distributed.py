"""The port's distribution (core/mesh.py, the step, loop parts, evaluation
and checkpoints on torch.distributed) on the CPU: gloo process groups of
2 and 4 ranks at the tiny widths of tests/test_torch_train.py, held against
the single-process port and the JAX package.

One module fixture runs everything once: the single-process port (two train
steps of a 4-clip global batch with GRAD_ACCUM 2, its checkpoint, an eval
forward, ``do_eval`` over a synthetic test split; the two steps again with
every dropout 0.1 and the loop's dropout generators), then every layout
(data 2, model 2, seq 2, data 2 x model 2, model 2 with dropout;
tests/torch_dist_worker.py, one spawned process per rank, the layouts side
by side) while the JAX package
takes the same two steps on one device and runs the same forward. The tests
read the results. Tolerances are stated at each comparison.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from stcat_tpu.data import synthetic as jsyn
from test_torch_train import NO_DROPOUT, SLICE, _jax_inputs, clip_arrays, jax_variables, port_cfg
from torch_dist_worker import (CHANGE_TOL, change_errors, fail_on_rank_one, generator,
                               noise_leaves, run_layout, state_digests)

from stcat_tpu_torch.config import merge_from_list
from stcat_tpu_torch.convert import from_jax_variables
from stcat_tpu_torch.core import mesh as meshlib
from stcat_tpu_torch.core.batch import VideoBatch, VideoTargets
from stcat_tpu_torch.core.dist import spawn_ranks
from stcat_tpu_torch.data.loader import make_loader
from stcat_tpu_torch.data.synthetic import SyntheticDataset
from stcat_tpu_torch.eval.engine import do_eval
from stcat_tpu_torch.eval.evaluator import build_evaluator
from stcat_tpu_torch.models import build_model
from stcat_tpu_torch.train.checkpoint import Checkpointer
from stcat_tpu_torch.train.optimizer import make_optimizer
from stcat_tpu_torch.train.step import (accumulate_grads, create_train_state, make_eval_forward,
                                        make_train_step)

STEPS = 2
DROPOUT = ["MODEL.STCAT.DROPOUT", 0.1, "MODEL.STCAT.HEAD_DROPOUT", 0.1,
           "MODEL.TEXT_MODEL.DROPOUT", 0.1]
# name: (ranks, config overrides)
LAYOUTS = {
    "data 2": (2, []),
    "model 2": (2, ["TPU.MODEL_PARALLEL", 2]),
    "seq 2": (2, ["TPU.MESH_SEQ", 2, "TPU.SEQUENCE_PARALLEL", "true"]),
    "data 2 x model 2": (4, ["TPU.MODEL_PARALLEL", 2]),
    # the loop's dropout generators: a tensor-parallel part takes its part
    # of the whole mask, so the masks are one process's
    "model 2 with dropout": (2, ["TPU.MODEL_PARALLEL", 2] + DROPOUT),
}


def _ref(layout: str) -> str:
    return "dropout" if "dropout" in layout else "plain"
ITEMS = 5  # synthetic test items


def _cfg(tmp):
    """tests/test_torch_train.py's slice (fp32, every dropout 0, the kernels'
    routes) with GRAD_ACCUM 2, and tests/test_torch_eval.py's synthetic split."""
    return tiny_cfg(NO_DROPOUT + SLICE + [
        "TPU.GRAD_ACCUM", 2, "SOLVER.BATCH_SIZE", 1, "DATA_DIR", str(tmp),
        "INPUT.RESOLUTION", 64, "INPUT.TRAIN_SAMPLE_NUM", 8, "INPUT.SAMPLE_FPS", 2,
        "INPUT.MAX_QUERY_LEN", 12, "TPU.FRAME_BUCKETS", "[16]", "DATALOADER.NUM_WORKERS", 1])


def _batch(arrays):
    return (VideoBatch(**{k: torch.from_numpy(v) for k, v in arrays[0].items()}),
            VideoTargets(**{k: torch.from_numpy(v) for k, v in arrays[1].items()}))


def _jax_reference(jcfg, params, consts, arrays, eval_arrays):
    """Two JAX make_train_step steps on one device, and the JAX eval forward."""
    from stcat_tpu.core.batch import VideoBatch as JBatch
    from stcat_tpu.core.mesh import make_mesh, replicate, shard_batch
    from stcat_tpu.models import STCATNet as JNet
    from stcat_tpu.train.optimizer import make_optimizer as jmake_opt
    from stcat_tpu.train.step import create_train_state as jcreate, make_train_step as jmake

    jb, jt = _jax_inputs(arrays)
    tx, _ = jmake_opt(jcfg, params, num_training_steps=10)
    mesh = make_mesh(1)
    jstate = replicate(jcreate(jcfg, {"params": params, "constants": consts}, tx), mesh)
    jstep = jmake(jcfg, JNet(jcfg), tx, mesh)
    losses = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, shard_batch(jb, mesh), shard_batch(jt, mesh),
                          jax.random.PRNGKey(7))
        losses.append({k: float(v) for k, v in m.items()})
    out = jax.jit(lambda b: JNet(jcfg).apply({"params": params, "constants": consts}, b))(
        JBatch(**{k: jnp.asarray(v) for k, v in eval_arrays.items()}))
    return (losses, from_jax_variables(jax.tree_util.tree_map(np.asarray, jstate.params), consts),
            {k: np.asarray(out[k]) for k in ("pred_boxes", "pred_sted")})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    jcfg = _cfg(tmp)
    cfg = port_cfg(jcfg)
    jsyn.write_synthetic_cache(str(tmp), "VidSTG", "test", n_items=ITEMS, n_frames=15)
    arrays = clip_arrays(b=4, t=6)
    eval_arrays = clip_arrays(b=2, t=8, seed=1)[0]

    # the single-process port, without and with dropout; ``fresh`` keeps the
    # seeded weights (the JAX variables are views of its tensors)
    fresh = build_model(cfg, "cpu", seed=0)
    params, consts = jax_variables(fresh, jcfg)
    single = {"init": {n: p.detach().clone() for n, p in fresh.named_parameters()}}
    for ref, run_cfg in (("plain", cfg), ("dropout", merge_from_list(cfg, DROPOUT))):
        model = build_model(run_cfg, "cpu", seed=0)
        opt = make_optimizer(run_cfg, model, num_training_steps=10)
        state = create_train_state(run_cfg, model, opt)
        step = make_train_step(run_cfg, model, opt, device="cpu")
        batch, targets = _batch(arrays)
        accumulate_grads(run_cfg, model, opt, batch, targets, generator(run_cfg, 0, 0))
        grad_norms = opt.grad_norms()
        noise = noise_leaves(model)
        losses = [{k: v.item() for k, v in step(state, batch, targets,
                                                generator(run_cfg, i, 0)).items()}
                  for i in range(STEPS)]
        Checkpointer(str(tmp / ref)).save(STEPS, state, block=True)
        single[ref] = {"losses": losses, "grad_norms": grad_norms, "noise": noise}
    fwd = make_eval_forward(cfg, fresh, device_split=False)(
        VideoBatch(**{k: torch.from_numpy(v) for k, v in eval_arrays.items()}))
    ev = build_evaluator(cfg)
    metrics = do_eval(cfg, fresh, make_loader(cfg, SyntheticDataset(cfg, "test"), "test"), ev)
    single.update(eval={k: v.numpy() for k, v in fwd.items()}, metrics=metrics,
                  items=sorted(ev.predictions))

    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        futures = {
            name: pool.submit(spawn_ranks, run_layout, ranks,
                              (merge_from_list(cfg, opts), arrays, eval_arrays,
                               str(tmp / _ref(name)), str(tmp / name.replace(" ", "_"))),
                              "gloo", None, 600)
            for name, (ranks, opts) in LAYOUTS.items()}
        jax_ref = _jax_reference(jcfg, params, consts, arrays, eval_arrays)
        layouts = {name: f.result() for name, f in futures.items()}
    return {"tmp": tmp, "cfg": cfg, "single": single, "jax": jax_ref, "layouts": layouts}


def _worst_change(changes: dict, exempt) -> tuple:
    return max(((n, e) for n, e in changes.items() if n not in exempt), key=lambda kv: kv[1])


def test_data_parallel_steps_match_jax(runs):
    """data 2 (each rank 2 of the 4 clips, GRAD_ACCUM 2): the losses of two
    steps against the JAX single-device step on the global batch (atol 2e-4
    / rtol 1e-3; they depend on the global num_boxes); each parameter's
    change from the seeded weights against the JAX step's change, relative
    per leaf within 5e-3 (a missing update reads 1, one of the wrong sign
    2); and, as well, every parameter within 5e-3 absolute, the bound of the
    JAX package's own test_tp_train_step_matches_data_parallel. Leaves with
    a noise gradient (NOISE_RMS) are held to the absolute bound only. The
    RoBERTa pooler, whose output the model does not use, is held to both:
    it steps on a zero gradient, decayed as optax decays it."""
    jlosses, jparams, _ = runs["jax"]
    ranks = runs["layouts"]["data 2"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for ours, theirs in zip(ranks[0]["losses"], jlosses):
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_allclose(ours[k], theirs[k], atol=2e-4, rtol=1e-3, err_msg=k)
    plain = runs["single"]["plain"]
    worst = _worst_change(change_errors(ranks[0]["params"], jparams, runs["single"]["init"]),
                          plain["noise"])
    assert worst[1] < CHANGE_TOL, worst
    for name, value in ranks[0]["params"].items():
        assert np.abs(value - jparams[name].numpy()).max() < 5e-3, name


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_match_the_single_process_step(runs, layout):
    """Each layout against the single-process port from the same weights on
    the same global batch. The global batch's gradient norm per optimizer
    group before the update at rtol 1e-4 (fp32 sums in another order; Adam
    and the clip would hide a gradient off by a factor); two steps' losses
    at atol 2e-4 / rtol 1e-3; each parameter's and EMA copy's change from
    the seeded weights (gathered to the whole layout) against the single
    process's, relative per leaf within 5e-3, leaves with a noise gradient
    (NOISE_RMS) excepted, and every parameter and EMA copy within 5e-3
    absolute as well. With dropout, against the single process's
    run with the same generators: a tensor-parallel part draws its part of
    the whole mask, and the replicated activations the same masks on every
    rank of the model group. Replicated parameters are bitwise equal on
    every rank, and each tensor-parallel part on every rank of its model
    index (the data and seq replicas): no replica drifts."""
    ranks, single = runs["layouts"][layout], runs["single"][_ref(layout)]
    for r in ranks:
        for g, n in single["grad_norms"].items():
            np.testing.assert_allclose(r["grad_norms"][g], n, rtol=1e-4, err_msg=g)
    for ours, theirs in zip(ranks[0]["losses"], single["losses"]):
        for k in ours:
            np.testing.assert_allclose(ours[k], theirs[k], atol=2e-4, rtol=1e-3, err_msg=k)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    for key in ("param_change", "ema_change"):
        worst = _worst_change(ranks[0][key], single["noise"])
        assert worst[1] < CHANGE_TOL, (key, worst)
    worst = max(ranks[0]["param_diff"].items(), key=lambda kv: kv[1])
    assert worst[1] < 5e-3, worst
    assert max(ranks[0]["ema_diff"].values()) < 5e-3
    for r in ranks[1:]:
        same_part = r["coords"].get("model", 0) == ranks[0]["coords"].get("model", 0)
        for name, (d, sharded) in r["local"].items():
            if same_part or not sharded:
                assert d == ranks[0]["local"][name][0], f"rank {r['rank']}: {name}"


@pytest.mark.parametrize("layout", ["model 2", "seq 2"])
def test_eval_forward_matches_jax(runs, layout):
    """The eval forward of the seeded weights on two 8-frame clips under
    model 2 (heads split) and seq 2 (4 frames per rank through the
    backbone) against the JAX single-device forward at atol 2e-4 / rtol 1e-3
    (fp32); every rank of the group returns the same, on every frame."""
    _, _, jout = runs["jax"]
    ranks = runs["layouts"][layout]
    for r in ranks:
        for k, v in jout.items():
            np.testing.assert_allclose(r["eval"][k], v, atol=2e-4, rtol=1e-3, err_msg=k)
        np.testing.assert_array_equal(r["eval"]["frame_valid"],
                                      runs["single"]["eval"]["frame_valid"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_do_eval_gives_the_single_process_metrics(runs, layout):
    """do_eval over the 5-item synthetic split: the single-process metrics
    at atol 1e-4 (test_torch_eval.py's bound), and each item's prediction
    sent to the gather once (the first rank of each model / seq group sends
    its data rank's items; the others send none)."""
    ranks = runs["layouts"][layout]
    metrics = ranks[0]["metrics"]
    assert metrics.keys() == runs["single"]["metrics"].keys()
    for k, v in runs["single"]["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, atol=1e-4, rtol=0, err_msg=k)
    sent = [i for r in ranks for i in r["sent"]]
    assert sorted(sent) == runs["single"]["items"] == list(range(ITEMS))
    # several processes: the batches are stacked on the host, as in the JAX package
    assert not any(r["device_split"] for r in ranks)


def test_checkpoints_cross_layouts_bitwise(runs):
    """model 2 restores the single-process checkpoint bitwise (each rank its
    parts of the weights, EMA and AdamW moments, and the step), and the
    checkpoint model 2 saved restores bitwise in one process: what it holds
    is the reference layout, equal to the gathered state."""
    ranks = runs["layouts"]["model 2"]
    for r in ranks:
        assert r["restored_at"] == STEPS and r["restore_mismatch"] == [], r["rank"]
    cfg = runs["cfg"]
    model = build_model(cfg, "cpu", seed=1)
    opt = make_optimizer(cfg, model, num_training_steps=10)
    state, at = Checkpointer(str(runs["tmp"] / "model_2")).restore(
        create_train_state(cfg, model, opt))
    got = state_digests({"model": model.state_dict(), "ema": state.ema,
                         "optimizer": opt.state_dict()})
    assert at == STEPS and got == ranks[0]["saved"]


@pytest.mark.parametrize("mode", ["train", "test"])
def test_loader_clips_per_rank_are_the_jax_loaders(tmp_path, mode):
    """On a (data 2, model 2) mesh each rank's loader is the JAX Loader of
    its data rank's shard (BATCH_SIZE x 4 / 2 clips, shard_index = the data
    coordinate, num_shards 2): the same indices and wrap-around mask every
    epoch, the same for both ranks of a model group; and the data ranks'
    batches together are the JAX single-host global batch of BATCH_SIZE x 4."""
    from stcat_tpu.data.loader import Loader as JLoader

    jcfg = tiny_cfg(["DATA_DIR", str(tmp_path), "SOLVER.BATCH_SIZE", 2, "SOLVER.MAX_EPOCH", 2])
    jsyn.write_synthetic_cache(str(tmp_path), "VidSTG", mode, n_items=13, n_frames=10)
    cfg = port_cfg(jcfg)
    dataset = SyntheticDataset(cfg, mode)
    whole = JLoader(jcfg, jsyn.SyntheticDataset(jcfg, mode), global_batch=8,
                    is_train=mode == "train")
    for epoch in range(2 if mode == "train" else 1):
        parts = {}
        for rank in range(4):
            mesh = meshlib.make_mesh(4, model_parallel=2, world_size=4, rank=rank)
            ours = make_loader(cfg, dataset, mode, mesh=mesh)
            theirs = JLoader(jcfg, jsyn.SyntheticDataset(jcfg, mode), global_batch=4,
                             is_train=mode == "train", shard_index=mesh.data_index,
                             num_shards=2)
            assert (ours.global_batch, ours.iters_per_epoch) == (4, theirs.iters_per_epoch)
            idx, pad = ours._epoch_indices(epoch)
            jidx, jpad = theirs._epoch_indices(epoch)
            np.testing.assert_array_equal(idx, jidx)
            np.testing.assert_array_equal(pad, jpad)
            parts.setdefault(mesh.data_index, idx)
            np.testing.assert_array_equal(parts[mesh.data_index], idx)
        jall, _ = whole._epoch_indices(epoch)
        for i in range(whole.iters_per_epoch):
            ours = np.concatenate([parts[d][i * 4:(i + 1) * 4] for d in (0, 1)])
            assert sorted(ours) == sorted(jall[i * 8:(i + 1) * 8]), (epoch, i)


def test_a_failing_rank_fails_the_run():
    """spawn_ranks waits on every rank: when one raises, the others (here
    rank 0, blocked in a barrier) stop or are terminated, and the tracebacks
    of the ranks that failed, the cause among them, are raised in the parent,
    well before the group's timeout."""
    import time

    t = time.monotonic()
    with pytest.raises(RuntimeError, match="of 2 failed(.|\n)*rank one fails on purpose"):
        spawn_ranks(fail_on_rank_one, 2, timeout_s=120)
    assert time.monotonic() - t < 60
