"""Card-only tests of the distribution: each layout (data 2, model 2, seq 2)
as two ranks on cuda:0 over gloo (NCCL refuses two ranks on one device; gloo
stages the card tensors through host memory), at tiny widths in fp32 with
every kernel route on, against one process on the same card. Marked
``cuda``; they skip without a card. torch only, like tests/test_torch_cuda.py:

    python -m pytest --noconftest tests/test_torch_cuda_dist.py -m cuda -q

Bounds: the losses of one step at atol 2e-4 / rtol 1e-3 and the global
batch's gradient norm per optimizer group at rtol 1e-3 (fp32 sums in
another order, cuDNN's backward included); the eval forward's boxes and
sted logits at atol 2e-4 / rtol 1e-3.
"""

import numpy as np
import pytest
import torch

from test_torch_cuda import _tiny_clips, tiny_cfg

pytestmark = pytest.mark.cuda

LAYOUTS = {
    "data 2": [],
    "model 2": ["TPU.MODEL_PARALLEL", 2],
    "seq 2": ["TPU.MESH_SEQ", 2, "TPU.SEQUENCE_PARALLEL", "true"],
}


def _cfg(extra=()):
    return tiny_cfg(["MODEL.STCAT.DROPOUT", 0.0, "MODEL.STCAT.HEAD_DROPOUT", 0.0,
                     "MODEL.TEXT_MODEL.DROPOUT", 0.0, "TPU.GRAD_ACCUM", 2,
                     "INPUT.RESOLUTION", 64, "INPUT.MAX_QUERY_LEN", 12, *extra])


def _run(cfg, raw, targets, mesh=None) -> dict:
    """One accumulation of the global batch's gradients (this rank's part
    of it on a mesh), their group norms, the update, and the eval forward
    of fresh seeded weights, with K1/K2/K3 launches."""
    from stcat_tpu_torch.core.batch import to_device
    from stcat_tpu_torch.core.mesh import shard_batch
    from stcat_tpu_torch.kernels import attention as pka
    from stcat_tpu_torch.kernels import bottleneck as pkb
    from stcat_tpu_torch.models import build_model
    from stcat_tpu_torch.train.optimizer import make_optimizer
    from stcat_tpu_torch.train.step import accumulate_grads, make_eval_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(cfg, "cuda", seed=0, mesh=mesh)
    opt = make_optimizer(cfg, model, num_training_steps=10)
    dev = model.input_proj.weight.device
    part, part_targets = (to_device(shard_batch(x, mesh), dev) for x in (raw, targets))
    for c in (pka.LAUNCHES, pka.BWD_LAUNCHES, pkb.LAUNCHES):
        c.reset()
    losses = {k: v.item() for k, v in accumulate_grads(cfg, model, opt, part, part_targets).items()}
    norms = opt.grad_norms()
    opt.step()
    launches = (pka.LAUNCHES.count, pka.BWD_LAUNCHES.count, pkb.LAUNCHES.count)
    out = make_eval_forward(cfg, build_model(cfg, "cuda", seed=0, mesh=mesh),
                            device_split=False)(part)
    return {"losses": losses, "norms": norms, "launches": launches,
            "eval": {k: out[k].cpu().numpy() for k in ("pred_boxes", "pred_sted")}}


def _rank(rank, cfg, raw, targets):
    from stcat_tpu_torch.core.mesh import mesh_from_config

    return _run(cfg, raw, targets, mesh_from_config(cfg))


@pytest.fixture(scope="module")
def one_process():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cfg = _cfg()
    raw, targets, _ = _tiny_clips(cfg, b=4)
    return cfg, raw, targets, _run(cfg, raw, targets)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_two_ranks_on_one_card_match_one_process(one_process, layout):
    from stcat_tpu_torch.config import merge_from_list
    from stcat_tpu_torch.core.dist import spawn_ranks

    cfg, raw, targets, ref = one_process
    ranks = spawn_ranks(_rank, 2, (merge_from_list(cfg, LAYOUTS[layout]), raw, targets),
                        backend="gloo", device="cuda:0", timeout_s=300)
    for r in ranks:
        assert all(n > 0 for n in r["launches"]), r["launches"]
        for k, v in ref["losses"].items():
            np.testing.assert_allclose(r["losses"][k], v, atol=2e-4, rtol=1e-3, err_msg=k)
        for g, n in ref["norms"].items():
            np.testing.assert_allclose(r["norms"][g], n, rtol=1e-3, err_msg=g)
    if layout != "data 2":  # each rank predicts every clip
        for r in ranks:
            for k, v in ref["eval"].items():
                np.testing.assert_allclose(r["eval"][k], v, atol=2e-4, rtol=1e-3, err_msg=k)
