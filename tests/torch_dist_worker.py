"""One rank of tests/test_torch_distributed.py's layouts (torch only: the
spawned ranks import neither JAX nor the JAX package).

``run_layout(rank, ...)`` runs on every rank of one layout, on the CPU over
gloo: the global batch's gradient norms per optimizer group, two train steps of the global batch from the seeded weights, the
state gathered back to the reference layout and compared there with the
single-process run's checkpoint, one eval forward, ``do_eval`` over the
synthetic test split, and (tensor parallel) a checkpoint saved, and the
single-process checkpoint restored. It returns small numbers and digests;
the test compares them."""

from __future__ import annotations

import hashlib

import torch

from stcat_tpu_torch.core import mesh as meshlib
from stcat_tpu_torch.core.batch import VideoBatch, VideoTargets
from stcat_tpu_torch.data.loader import make_loader
from stcat_tpu_torch.data.synthetic import SyntheticDataset
from stcat_tpu_torch.eval import evaluator as evaluator_mod
from stcat_tpu_torch.eval.engine import do_eval
from stcat_tpu_torch.models import build_model
from stcat_tpu_torch.train.checkpoint import Checkpointer, map_moments, whole_state
from stcat_tpu_torch.train.loop import step_generator
from stcat_tpu_torch.train.optimizer import make_optimizer
from stcat_tpu_torch.train.step import (accumulate_grads, create_train_state,
                                        eval_device_split_active, make_eval_forward,
                                        make_train_step)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def state_digests(state) -> dict:
    """sha1 of every tensor a checkpoint holds: model, EMA and moments."""
    out = {f"model.{k}": digest(v) for k, v in state["model"].items()}
    out.update({f"ema.{k}": digest(v) for k, v in state["ema"].items()})
    for i, st in state["optimizer"]["core"]["state"].items():
        out.update({f"opt.{i}.{k}": digest(torch.as_tensor(v)) for k, v in st.items()})
    out["count"] = str(state["optimizer"]["count"])
    return out


def _max_diffs(ours: dict, ref: dict) -> dict:
    return {k: (v.float() - ref[k].float()).abs().max().item() for k, v in ours.items()}


# A leaf whose single-process gradient has an RMS below this is rounding
# noise (fp32's unit roundoff is 1.2e-7): the gradient of something the loss
# does not depend on, such as an attention key's bias, which shifts every
# logit of a query alike. Adam's first steps turn such noise into +-LR
# steps of either sign, so these leaves are held to the absolute bound only.
# At tests/test_torch_distributed.py's widths they read <= 1.6e-8 and the
# smallest real gradient 7.9e-6.
NOISE_RMS = 1e-7
CHANGE_TOL = 5e-3  # relative, on each leaf's change from the seeded weights


def noise_leaves(model: torch.nn.Module) -> set:
    """The parameters whose ``.grad`` has an RMS below NOISE_RMS."""
    return {n for n, p in model.named_parameters()
            if p.grad is not None and p.grad.norm() < NOISE_RMS * p.numel() ** 0.5}


def change_errors(ours: dict, ref: dict, init: dict) -> dict:
    """Per leaf, how far this run's change from ``init`` is from the
    reference's: |(ours - init) - (ref - init)| / |ref - init| (Frobenius
    norms, in float64); a leaf the reference left as it was must stay so."""
    out = {}
    for k, v in ours.items():
        start = torch.as_tensor(init[k]).double()
        want = torch.as_tensor(ref[k]).double() - start
        err = (torch.as_tensor(v).double() - start - want).norm().item()
        scale = want.norm().item()
        out[k] = err / scale if scale else (0.0 if err == 0 else float("inf"))
    return out


def generator(cfg, iteration: int, data_index: int):
    """The loop's dropout generator of a step; None without dropout."""
    s, t = cfg.MODEL.STCAT, cfg.MODEL.TEXT_MODEL
    if not (s.DROPOUT or s.HEAD_DROPOUT or t.DROPOUT):
        return None
    return step_generator(cfg, iteration, "cpu", data_index)


def run_layout(rank, cfg, arrays, eval_arrays, ref_dir, out_dir, steps=2):
    """cfg's TPU section names the layout (mesh_from_config) and DATA_DIR
    holds the synthetic data; ``ref_dir`` holds the single-process run's
    checkpoint, ``out_dir`` takes this layout's."""
    torch.set_num_threads(1)
    mesh = meshlib.mesh_from_config(cfg)
    mp = mesh.model_parallel
    ref = torch.load(f"{ref_dir}/checkpoints/model_{steps:08d}.pt", weights_only=True)
    out = {"rank": rank, "coords": mesh.coords}

    # two train steps of the global batch
    model = build_model(cfg, "cpu", seed=0, mesh=mesh)
    opt = make_optimizer(cfg, model, num_training_steps=10)
    state = create_train_state(cfg, model, opt)
    step = make_train_step(cfg, model, opt, device="cpu")
    batch = meshlib.shard_batch(VideoBatch(**{k: torch.from_numpy(v)
                                              for k, v in arrays[0].items()}), mesh)
    targets = meshlib.shard_batch(VideoTargets(**{k: torch.from_numpy(v)
                                                  for k, v in arrays[1].items()}), mesh)
    # the reference layout's weights before any step
    init = {k: v.clone() for k, v in meshlib.gather_state_dict(model.state_dict(), mesh).items()}
    # the global batch's gradients
    accumulate_grads(cfg, model, opt, batch, targets, generator(cfg, 0, mesh.data_index))
    out["grad_norms"] = opt.grad_norms()
    out["losses"] = [{k: v.item() for k, v in step(
        state, batch, targets, generator(cfg, i, mesh.data_index)).items()} for i in range(steps)]
    out["local"] = {n: (digest(p), meshlib.tp_rule(n, p.dim()) is not None)
                    for n, p in model.named_parameters()}
    whole = whole_state(state, mesh)
    if rank == 0:
        params = {n: whole["model"][n] for n, _ in model.named_parameters()}
        out["param_diff"] = _max_diffs(params, ref["model"])
        out["ema_diff"] = _max_diffs(whole["ema"], ref["ema"])
        out["param_change"] = change_errors(params, ref["model"], init)
        out["ema_change"] = change_errors(whole["ema"], ref["ema"], init)
        out["params"] = {n: v.numpy() for n, v in params.items()} if mesh.size == 2 \
            and mesh.data_parallel == 2 else None

    # one eval forward of fresh seeded weights
    fresh = build_model(cfg, "cpu", seed=0, mesh=mesh)
    eval_batch = meshlib.shard_batch(VideoBatch(**{k: torch.from_numpy(v)
                                                   for k, v in eval_arrays.items()}), mesh)
    res = make_eval_forward(cfg, fresh, device_split=False)(eval_batch)
    out["eval"] = {k: v.numpy() for k, v in res.items()}

    # do_eval over the synthetic test split, recording what each rank sends
    sent = []
    gather = evaluator_mod.all_gather_objects

    def recording(obj, group=None):
        sent.append(sorted(obj))
        return gather(obj, group)

    evaluator_mod.all_gather_objects = recording
    try:
        loader = make_loader(cfg, SyntheticDataset(cfg, "test"), "test", mesh=mesh)
        out["metrics"] = do_eval(cfg, fresh, loader, evaluator_mod.build_evaluator(cfg))
    finally:
        evaluator_mod.all_gather_objects = gather
    out["sent"] = sent[0]
    out["device_split"] = eval_device_split_active(cfg)

    if mp > 1:
        # this layout's checkpoint, in the reference layout
        Checkpointer(out_dir, mesh=mesh).save(steps, state, block=True)
        if rank == 0:
            out["saved"] = state_digests(whole)
        # the single-process checkpoint, restored onto this layout
        model_b = build_model(cfg, "cpu", seed=1, mesh=mesh)
        opt_b = make_optimizer(cfg, model_b, num_training_steps=10)
        state_b, at = Checkpointer(ref_dir, mesh=mesh).restore(
            create_train_state(cfg, model_b, opt_b))
        want = {"model": meshlib.shard_state_dict(ref["model"], mesh),
                "ema": meshlib.shard_state_dict(ref["ema"], mesh),
                "optimizer": map_moments(ref["optimizer"], opt_b.param_names,
                                         lambda d: meshlib.shard_state_dict(d, mesh))}
        got = {"model": model_b.state_dict(), "ema": state_b.ema,
               "optimizer": opt_b.state_dict()}
        expect = state_digests(want)
        out["restored_at"] = at
        out["restore_mismatch"] = sorted(k for k, v in state_digests(got).items()
                                         if expect[k] != v)
    return out


def fail_on_rank_one(rank):
    """Rank 1 raises; rank 0 waits for it in a collective that never ends."""
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    torch.distributed.barrier()
