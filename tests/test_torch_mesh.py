"""The port's mesh (stcat_tpu_torch/core/mesh.py) against the JAX package's
core/mesh.py, without processes: the rank layout against the JAX device grid
on the 8-device CPU mesh, the tensor-parallel partition rules against JAX
``tp_spec`` through ``convert.py::from_jax_variables``, the
``min_model_sharded`` guard, and the batch field policy and each rank's
part of a global batch against ``batch_specs`` and the shards JAX places on
each device. Everything here is exact (integers, owner maps, slices)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from helpers import make_batch_and_targets, tiny_cfg
from stcat_tpu.core import batch as jbatch
from stcat_tpu.core import mesh as jmesh
from stcat_tpu.models import STCATNet as JNet

from stcat_tpu.config import to_dict
from stcat_tpu_torch import config as pconfig
from stcat_tpu_torch.config import default_config, merge_from_list
from stcat_tpu_torch.convert import from_jax_variables
from stcat_tpu_torch.core import batch as pbatch
from stcat_tpu_torch.core import mesh as pmesh
from stcat_tpu_torch.models import build_model


def port_cfg(jcfg):
    return pconfig._merge_dict(pconfig.default_config(), to_dict(jcfg))


LAYOUTS = [  # (model_parallel, seq_parallel, sequence_parallel)
    (1, 1, False),  # (8,) data
    (2, 1, False),  # (4, 2) data x model
    (1, 2, True),   # (4, 2) data x seq
    (2, 2, True),   # (2, 2, 2) data x seq x model
]


@pytest.mark.parametrize("mp,sp,seq", LAYOUTS)
def test_rank_layout_is_the_jax_device_grid(mp, sp, seq):
    jm = jmesh.make_mesh(8, model_parallel=mp, seq_parallel=sp)
    grid = np.vectorize(lambda d: d.id)(jm.devices)
    for rank in range(8):
        pm = pmesh.make_mesh(8, model_parallel=mp, seq_parallel=sp, world_size=8, rank=rank)
        assert pm.axis_names == tuple(jm.axis_names)
        assert pm.shape == dict(jm.shape)
        np.testing.assert_array_equal(pm.devices, grid)
        where = np.argwhere(grid == rank)[0]
        assert pm.coords == dict(zip(jm.axis_names, map(int, where)))
        assert pm.sequence_parallel == seq
    # the model axis is innermost: a model group is a run of adjacent ranks
    if mp > 1:
        assert all(list(line) == list(range(line[0], line[0] + mp))
                   for line in pm.lines(pmesh.MODEL_AXIS))


def test_mesh_from_config_and_refusals_match_jax():
    cfg = merge_from_list(default_config(), ["TPU.MESH_DATA", 2, "TPU.MODEL_PARALLEL", 2,
                                             "TPU.MESH_SEQ", 2, "TPU.SEQUENCE_PARALLEL", "true"])
    pm = pmesh.make_mesh(8, 2, 2, world_size=8, rank=5)
    jm = jmesh.mesh_from_config(tiny_cfg(["TPU.MESH_DATA", 2, "TPU.MODEL_PARALLEL", 2,
                                          "TPU.MESH_SEQ", 2, "TPU.SEQUENCE_PARALLEL", "true"]))
    assert dict(jm.shape) == pm.shape == {"data": 2, "seq": 2, "model": 2}
    with pytest.raises(ValueError, match="world has 1 rank"):  # one process per device
        pmesh.mesh_from_config(cfg)
    with pytest.raises(ValueError) as jax_err:
        jmesh.make_mesh(6, model_parallel=4)
    with pytest.raises(ValueError) as port_err:
        pmesh.make_mesh(6, model_parallel=4, world_size=6, rank=0)
    assert str(port_err.value) == str(jax_err.value)
    # 1-D sequence parallelism: the frame axis takes the data axis, clips replicate
    one_d = pmesh.make_mesh(4, sequence_parallel=True, world_size=4, rank=3)
    assert (one_d.frame_axis, one_d.clip_axis, one_d.data_parallel, one_d.seq_parallel) == \
        ("data", None, 1, 4)
    assert [pmesh.make_mesh(8, 2, 2, world_size=8, rank=r).is_group_leader
            for r in range(8)] == [True, False, False, False, True, False, False, False]


def _owner_maps(variables, mp):
    """Each leaf filled with the model rank + 1 that owns each element under
    JAX's tp_spec (0: replicated)."""
    def owner(path, leaf):
        spec = jmesh.tp_spec(jmesh._path_str(path), leaf)
        out = np.zeros(leaf.shape, np.float32)
        for dim, ax in enumerate(spec):
            if ax == jmesh.MODEL_AXIS:
                n = leaf.shape[dim] // mp
                idx = np.arange(leaf.shape[dim]) // n + 1
                shape = [1] * leaf.ndim
                shape[dim] = -1
                out = out + idx.reshape(shape)
        return out
    return jax.tree_util.tree_map_with_path(owner, variables)


@pytest.mark.parametrize("extra", [[], ["MODEL.STCAT.FROM_SCRATCH", "false"]])
def test_partition_rules_shard_what_jax_tp_spec_shards(extra):
    """Every port parameter's rule against JAX tp_spec of the leaves it comes
    from, element by element: the JAX owner map of each leaf goes through
    from_jax_variables, and part r of the port's cut must hold exactly the
    elements JAX places on model rank r (each q / k / v block of a packed
    in_proj separately); replicated leaves stay whole. The parallelized
    model's parameters have the cut's shapes."""
    mp = 2
    jcfg = tiny_cfg(["TPU.MODEL_PARALLEL", mp] + extra)
    batch, _ = make_batch_and_targets(b=1, t=8)
    shapes = jax.eval_shape(JNet(jcfg).init, jax.random.PRNGKey(0), batch)
    owners = _owner_maps(shapes, mp)
    sd = from_jax_variables(owners["params"], owners.get("constants", {}))
    pcfg = port_cfg(jcfg)
    whole = build_model(pcfg, device="cpu", seed=0).state_dict()
    assert set(sd) == set(whole)
    n_sharded = 0
    for name, own in sd.items():
        rule = pmesh.tp_rule(name, own.dim())
        if name.endswith(("running_mean", "running_var")):  # made by the converter
            assert rule is None, name
            continue
        if rule is None:
            assert not own.any(), f"{name}: JAX shards it, the port replicates it"
            continue
        n_sharded += 1
        assert own.min() > 0, f"{name}: the port shards it, JAX replicates part of it"
        for r in range(mp):
            part = pmesh.shard_tensor(own, rule, r, mp)
            assert (part == r + 1).all(), f"{name}: part {r} holds another rank's elements"
        assert torch.equal(pmesh.unshard_tensor(
            [pmesh.shard_tensor(own, rule, r, mp) for r in range(mp)], rule), own), name
    assert n_sharded >= 2 * (jcfg.MODEL.STCAT.ENC_LAYERS + 2 * jcfg.MODEL.STCAT.DEC_LAYERS)
    assert any(n.endswith("self_attn.in_proj_weight") for n in sd)
    for rank in range(mp):
        mesh = pmesh.make_mesh(mp, model_parallel=mp, world_size=mp, rank=rank)
        local = build_model(pcfg, device="cpu", seed=0, mesh=mesh).state_dict()
        assert set(local) == set(whole)
        for name, v in local.items():
            assert torch.equal(v, pmesh.shard_tensor(whole[name], pmesh.tp_rule(name, v.dim()),
                                                     rank, mp)), name
        # a whole state_dict (from_jax_variables' output) cut to this rank's parts
        mine = pmesh.shard_state_dict(whole, mesh)
        assert mine.keys() == local.keys() and all(torch.equal(mine[k], local[k]) for k in mine)


def test_min_model_sharded_guard_matches_jax():
    tree = {"enc": {"q_proj": {"kernel": np.zeros((4, 4)), "bias": np.zeros(4)},
                    "norm": {"scale": np.zeros(4)}}}
    with pytest.raises(ValueError) as jax_err:
        jmesh.state_shardings(tree, jmesh.make_mesh(2, model_parallel=2), min_model_sharded=3)
    names = [("enc.self_attn.in_proj_weight", 2), ("enc.self_attn.in_proj_bias", 1),
             ("enc.norm.weight", 1)]
    with pytest.raises(ValueError) as port_err:
        pmesh.sharded_names(names, min_model_sharded=3)
    assert str(port_err.value) == str(jax_err.value)
    assert set(pmesh.sharded_names(names, min_model_sharded=2)) == {
        "enc.self_attn.in_proj_weight", "enc.self_attn.in_proj_bias"}
    # renamed modules degrade to replication and trip the guard
    renamed = [(n.replace("linear", "dense").replace("in_proj", "packed").replace(
        "_proj", "_p").replace("query", "q").replace("key", "k").replace("value", "v")
        .replace("intermediate", "inter").replace("output", "out"), p.dim())
        for n, p in build_model(port_cfg(tiny_cfg()), "cpu").named_parameters()]
    with pytest.raises(ValueError, match="partition rules matched only 0 leaves"):
        pmesh.sharded_names(renamed, min_model_sharded=12)


def _jax_batches(b=8, t=8):
    """A VideoBatch, rgb and yuv RawVideoBatches and VideoTargets of numpy
    arrays, and the port's containers of the same arrays."""
    rng = np.random.RandomState(0)
    vb, tg = make_batch_and_targets(b=b, t=t, h=8, w=8)
    vb = jax.tree_util.tree_map(np.asarray, vb)
    tg = jax.tree_util.tree_map(np.asarray, tg)
    common = dict(frame_valid=vb.frame_valid, flip=rng.rand(b) > 0.5,
                  affine_scale=rng.rand(b, 2).astype(np.float32),
                  affine_off=rng.rand(b, 2).astype(np.float32),
                  out_size=np.full((b, 2), 8, np.int32), token_ids=vb.token_ids,
                  token_valid=vb.token_valid, out_canvas=(8, 8))
    rgb = dict(frames_u8=rng.randint(0, 255, (b, t, 9, 9, 3)).astype(np.uint8), **common)
    yuv = dict(frames_u8=None, frames_y=rng.randint(0, 255, (b, t, 10, 10)).astype(np.uint8),
               frames_cbcr=rng.randint(0, 255, (b, t, 5, 5, 2)).astype(np.uint8), **common)
    pairs = [(vb, pbatch.VideoBatch(**{f.name: getattr(vb, f.name)
                                      for f in dataclasses.fields(pbatch.VideoBatch)})),
             (tg, pbatch.VideoTargets(**{f.name: getattr(tg, f.name)
                                         for f in dataclasses.fields(pbatch.VideoTargets)})),
             (jbatch.RawVideoBatch(**rgb), pbatch.RawVideoBatch(**rgb)),
             (jbatch.RawVideoBatch(**yuv), pbatch.RawVideoBatch(**yuv))]
    return pairs


@pytest.mark.parametrize("mp,sp,seq", LAYOUTS + [(2, 1, True), (1, 1, True)])
def test_batch_policy_and_rank_parts_match_jax(mp, sp, seq):
    """Field by field: the port's batch_specs equal JAX's; and each rank's
    ``shard_batch`` of a global batch equals the shard JAX places on that
    device under those specs (``local_batch`` of the data rank's clips too)."""
    jm = jmesh.make_mesh(8, model_parallel=mp, seq_parallel=sp)
    for jb, pb in _jax_batches():
        specs = jmesh.batch_specs(jb, seq, jm)
        pspecs = pmesh.batch_specs(pb, seq, pmesh.make_mesh(8, mp, sp, seq, world_size=8, rank=0))
        jflat = {f.name: getattr(specs, f.name) for f in dataclasses.fields(jb)
                 if getattr(jb, f.name) is not None and hasattr(getattr(jb, f.name), "shape")}
        assert {k: tuple(v) for k, v in jflat.items()} == pspecs
        for rank in range(8):
            pm = pmesh.make_mesh(8, mp, sp, seq, world_size=8, rank=rank)
            mine = pmesh.shard_batch(pb, pm)
            n = getattr(pb, next(iter(pspecs))).shape[0] // pm.data_parallel
            clips = dataclasses.replace(pb, **{
                k: getattr(pb, k)[pm.data_index * n:(pm.data_index + 1) * n] for k in pspecs})
            for name, spec in jflat.items():
                placed = jax.device_put(getattr(jb, name), NamedSharding(jm, spec))
                shard = next(s for s in placed.addressable_shards if s.device.id == rank)
                np.testing.assert_array_equal(getattr(mine, name), np.asarray(shard.data),
                                              err_msg=f"{name} rank {rank}")
                np.testing.assert_array_equal(getattr(pmesh.local_batch(clips, pm), name),
                                              np.asarray(shard.data))


def test_gloo_stages_card_tensors_through_the_host(monkeypatch, caplog):
    """The staging rule reads the group's backend name: a card tensor on a
    gloo group goes through host memory (logged once), on an NCCL group it
    does not, and a CPU tensor never does."""
    from types import SimpleNamespace

    from stcat_tpu_torch.core import collectives

    card, host = SimpleNamespace(is_cuda=True), SimpleNamespace(is_cuda=False)
    collectives._note_staging.cache_clear()
    for backend, want in (("gloo", True), ("nccl", False)):
        monkeypatch.setattr(collectives.td, "get_backend", lambda group, b=backend: b)
        with caplog.at_level("INFO", logger="stcat_tpu_torch"):
            assert collectives.staged(card, object()) is want
            assert collectives.staged(host, object()) is False
            assert collectives.staged(card, object()) is want
    assert sum("host memory" in r.message for r in caplog.records) == 1


@pytest.mark.parametrize("dim", [1, -1])
def test_a_tensor_parallel_part_draws_its_part_of_the_whole_mask(dim):
    """dropout(shard=(dim, i, parts)) on part i equals part i of the whole
    tensor's dropout from an equally seeded generator (attention weights cut
    on the head axis, FFN units on the last), and the generator ends where
    the whole draw leaves it."""
    from stcat_tpu_torch.ops.misc import dropout

    x = torch.randn(2, 4, 3, 6, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    whole = dropout(x, 0.3, True, g)
    for i, part in enumerate(x.chunk(2, dim)):
        gi = torch.Generator().manual_seed(3)
        assert torch.equal(dropout(part, 0.3, True, gi, shard=(dim, i, 2)),
                           whole.chunk(2, dim)[i])
        assert torch.equal(gi.get_state(), g.get_state())


def test_dropout_generators_are_seeded_by_iteration_and_data_rank():
    """Data rank 0 draws what one process draws (a resumed run too); other
    data ranks draw their own; the ranks of a model or seq group, which
    share a data index, draw the same."""
    from stcat_tpu_torch.train.loop import step_generator

    cfg = port_cfg(tiny_cfg())
    first = step_generator(cfg, 7, "cpu").initial_seed()
    assert first == (cfg.SEED + 1) * 1_000_003 + 7
    assert step_generator(cfg, 7, "cpu", 0).initial_seed() == first
    assert step_generator(cfg, 7, "cpu", 1).initial_seed() not in (first, step_generator(
        cfg, 8, "cpu").initial_seed())
    assert step_generator(cfg, 7, "cpu", 1).initial_seed() == \
        step_generator(cfg, 7, "cpu", 1).initial_seed()
