"""The MODEL.USE_LSTM text variant against the JAX package's, on the CPU.

``LSTMTextEncoder`` against the JAX one with the JAX weights carried by
``convert.lstm_text`` (bi- and unidirectional, one and two layers, ragged
lengths down to 1, every position including the pads) at atol 2e-5; the
GloVe table; a tiny STCATNet with the LSTM against the JAX model at atol
2e-4 / rtol 1e-3 (tests/test_full_parity.py's tolerance), weights through
``from_jax_variables``; two train steps against the JAX step (flax's one
bias per gate against the port's ``bias_ih`` + ``bias_hh``); that the
variant trains (its gradients reach the LSTM, in the text group, and
``bias_ih`` stays 0), restores a state trained with a nonzero ``bias_ih``
and serves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from stcat_tpu.core.batch import VideoBatch as JBatch
from stcat_tpu.models import STCATNet as JNet
from stcat_tpu.models.lstm_text import LSTMTextEncoder as JEncoder
from test_torch_model import _batch_arrays, port_cfg
from test_torch_train import NO_DROPOUT, SLICE, _jax_inputs, clip_arrays, port_batch
from torch_dist_worker import CHANGE_TOL, change_errors, noise_leaves

from stcat_tpu_torch.convert import Writer, from_jax_variables, lstm_text
from stcat_tpu_torch.core.batch import VideoBatch as PBatch
from stcat_tpu_torch.models import STCATNet as PNet, build_model
from stcat_tpu_torch.models.lstm_text import LSTMTextEncoder
from stcat_tpu_torch.train.optimizer import make_optimizer
from stcat_tpu_torch.train.step import accumulate_grads, create_train_state, make_train_step

LSTM = ["MODEL.USE_LSTM", "true", "MODEL.LSTM.HIDDEN_SIZE", 16, "MODEL.LSTM.EMBED_DIM", 12]


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_encoder_matches_jax(bidirectional, layers):
    """Rows of 9, 5, 1 and 2 valid tokens: features at every position (the
    pads too: both sides run the LSTM over them) and the sentence vector."""
    kw = dict(d_model=16, hidden_size=8, embed_dim=12, num_layers=layers,
              bidirectional=bidirectional)
    ids = np.random.RandomState(0).randint(0, 50, (4, 9)).astype(np.int32)
    valid = np.arange(9)[None] < np.asarray([[9], [5], [1], [2]])
    enc = JEncoder(vocab_size=50, **kw)
    variables = enc.init(jax.random.PRNGKey(layers), jnp.asarray(ids), jnp.asarray(valid))
    feats, cls = enc.apply(variables, jnp.asarray(ids), jnp.asarray(valid))
    w = Writer()
    lstm_text(w, jax.tree_util.tree_map(np.asarray, variables["params"]))
    ours = LSTMTextEncoder(50, **kw)
    ours.load_state_dict(w.sd, strict=True)
    with torch.no_grad():
        pf, pc = ours(torch.from_numpy(ids), torch.from_numpy(valid))
    assert pf.shape == (4, 9, 16) and pc.shape == (4, 16)
    np.testing.assert_allclose(pf.numpy(), np.asarray(feats), atol=2e-5, rtol=0)
    np.testing.assert_allclose(pc.numpy(), np.asarray(cls), atol=2e-5, rtol=0)


def test_glove_table_initialises_the_embedding(tmp_path):
    """A GloVe .npy becomes the embedding, as in the JAX init, and survives
    build_model's seeded init; a missing file leaves the drawn init (normal,
    std 1/sqrt(embed_dim)); a table of the wrong shape is refused."""
    table = np.random.RandomState(0).randn(128, 12).astype(np.float32)
    path = str(tmp_path / "glove.npy")
    np.save(path, table)
    jenc = JEncoder(vocab_size=128, d_model=16, hidden_size=8, embed_dim=12, num_layers=1,
                    glove_path=path)
    ids, valid = jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), bool)
    jtable = jenc.init(jax.random.PRNGKey(0), ids, valid)["params"]["embedding"]["embedding"]
    cfg = port_cfg(tiny_cfg(LSTM + ["MODEL.LSTM.GLOVE_PATH", path]))
    for model in (PNet(cfg), build_model(cfg, device="cpu", seed=3)):
        got = model.text_encoder.embedding.weight.detach().numpy()
        np.testing.assert_array_equal(got, table)
        np.testing.assert_array_equal(got, np.asarray(jtable))
    drawn = build_model(port_cfg(tiny_cfg(LSTM + ["MODEL.LSTM.GLOVE_PATH", path + ".absent"])),
                        device="cpu", seed=3).text_encoder.embedding.weight
    assert abs(drawn.std().item() - 12 ** -0.5) < 0.03
    np.save(path, table[:, :10])
    with pytest.raises(ValueError, match="GloVe table"):
        PNet(cfg)


def test_stcatnet_with_lstm_matches_jax():
    """The whole tiny model with MODEL.USE_LSTM (padded frames, pixels and
    tokens): every output, aux layers included, at atol 2e-4 / rtol 1e-3."""
    jcfg = tiny_cfg(LSTM + ["TPU.CONV_IMPL", "pallas", "TPU.CONV_STAGES", "[1,2,3,4]"])
    arrays = _batch_arrays()
    jbatch = JBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmodel = JNet(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    ref = jax.jit(jmodel.apply)(variables, jbatch)
    sd = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables["params"]),
                            jax.tree_util.tree_map(np.asarray, variables["constants"]))
    ours = PNet(port_cfg(jcfg)).eval()
    ours.load_state_dict(sd, strict=True)
    assert not any(k.startswith("text_encoder.body.") for k in sd)
    with torch.no_grad():
        out = ours(PBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))
    for key in ("pred_boxes", "pred_sted", "pred_actioness", "weights"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=2e-4,
                                   rtol=1e-3, err_msg=key)
    for oa, ra in zip(out["aux_outputs"], ref["aux_outputs"]):
        for key in ra:
            np.testing.assert_allclose(oa[key].numpy(), np.asarray(ra[key]), atol=2e-4,
                                       rtol=1e-3, err_msg=f"aux {key}")


def test_lstm_variant_two_steps_match_jax():
    """Two make_train_step steps of the variant (tiny widths, every dropout
    0, AdamW, WEIGHT_DECAY 1e-2) against the JAX make_train_step on a
    1-device mesh, from the JAX init's weights (``from_jax_variables``).
    The losses at rtol 1e-4; each leaf's change from those weights against
    the JAX step's, relative within 5e-3, and every leaf within 5e-3
    absolute, as tests/test_torch_distributed.py holds data 2 against JAX
    (``change_errors``: a missing update reads 1, a doubled one 1 too;
    leaves with a noise gradient, NOISE_RMS, to the absolute bound only).
    flax's cell has one bias per gate, its hidden kernel's, held against
    the port's ``bias_ih_l0 + bias_hh_l0``; ``bias_ih_l0`` stays exactly 0."""
    from stcat_tpu.core.mesh import make_mesh, replicate, shard_batch
    from stcat_tpu.train.optimizer import make_optimizer as jmake_opt
    from stcat_tpu.train.step import create_train_state as jcreate, make_train_step as jmake

    jcfg = tiny_cfg(LSTM + NO_DROPOUT + SLICE + ["SOLVER.WEIGHT_DECAY", 1e-2])
    arrays = clip_arrays()
    jb, jt = _jax_inputs(arrays)
    variables = jax.jit(JNet(jcfg).init)(jax.random.PRNGKey(0), jb)
    params, consts = variables["params"], variables["constants"]
    # copies: the JAX step donates the state's buffers
    np_consts = jax.tree_util.tree_map(np.array, consts)
    init = from_jax_variables(jax.tree_util.tree_map(np.array, params), np_consts)
    tx, _ = jmake_opt(jcfg, params, num_training_steps=10)
    mesh = make_mesh(1)
    jstate = replicate(jcreate(jcfg, {"params": params, "constants": consts}, tx), mesh)
    jstep = jmake(jcfg, JNet(jcfg), tx, mesh)
    jlosses = []
    for _ in range(2):
        jstate, m = jstep(jstate, shard_batch(jb, mesh), shard_batch(jt, mesh),
                          jax.random.PRNGKey(7))
        jlosses.append(float(m["loss"]))

    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, jstate.params), np_consts)
    cfg = port_cfg(jcfg)
    model = build_model(cfg, device="cpu", seed=0)
    model.load_state_dict(init, strict=True)
    opt = make_optimizer(cfg, model, num_training_steps=10)
    state = create_train_state(cfg, model, opt)
    step = make_train_step(cfg, model, opt, device="cpu")
    batch, targets = port_batch(arrays)
    accumulate_grads(cfg, model, opt, batch, targets)
    noise = noise_leaves(model)
    losses = [step(state, batch, targets, torch.Generator().manual_seed(7))["loss"].item()
              for _ in range(2)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)

    ours = {n: p.detach() for n, p in model.named_parameters()}
    input_biases = [n for n in ours if n.endswith("bias_ih_l0")]
    assert input_biases
    for n in input_biases:
        assert torch.equal(ours[n], torch.zeros_like(ours[n])), n
        hidden = n.replace("bias_ih_l0", "bias_hh_l0")
        ours[hidden] = ours[n] + ours[hidden]
    errors = change_errors(ours, want, init)
    worst = max(((n, e) for n, e in errors.items() if n not in noise), key=lambda kv: kv[1])
    assert worst[1] < CHANGE_TOL, worst
    for name, value in ours.items():
        assert (value - want[name]).abs().max().item() < 5e-3, name


def test_lstm_variant_trains():
    """Two train steps of the variant: finite losses, every LSTM weight in
    the text group with a gradient and moved but each ``bias_ih_l0``, which
    stays exactly 0 (flax's input kernels have no bias), TEXT_MODEL.FREEZE
    leaving the LSTM trainable (it freezes only a RoBERTa body, as in the
    JAX labels)."""
    cfg = port_cfg(tiny_cfg(LSTM + NO_DROPOUT + ["MODEL.TEXT_MODEL.FREEZE", "true"]))
    model = build_model(cfg, device="cpu", seed=0)
    opt = make_optimizer(cfg, model, num_training_steps=10)
    lstm = [n for n in opt.labels if n.startswith("text_encoder.")]
    assert lstm and all(opt.labels[n] == "text" for n in lstm)
    state = create_train_state(cfg, model, opt)
    before = {n: p.detach().clone() for n, p in model.named_parameters() if n in lstm}
    step = make_train_step(cfg, model, opt, device="cpu")
    batch, targets = port_batch(clip_arrays())
    for _ in range(2):
        losses = step(state, batch, targets, torch.Generator().manual_seed(0))
        assert np.isfinite(losses["loss"].item())
    named = dict(model.named_parameters())
    input_biases = [n for n in lstm if n.endswith("bias_ih_l0")]
    assert input_biases
    assert [n for n in lstm if not torch.equal(named[n].detach(), before[n])] \
        == [n for n in lstm if n not in input_biases]
    for n in input_biases:
        assert torch.equal(named[n].detach(), torch.zeros_like(before[n])), n


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_lstm_state_with_trained_input_bias_restores(tmp_path, optimizer):
    """A checkpoint of the variant trained while ``bias_ih_l0`` still took
    a gradient (nonzero input biases and their moments) restores into the
    model: each input bias folded into its hidden one (the text encoder's
    output at atol 1e-6, fp32 sums in another order), ``bias_ih_l0`` 0, and
    exactly 0 after a further step (adam's stale moments are dropped)."""
    from stcat_tpu_torch.train.checkpoint import Checkpointer

    cfg = port_cfg(tiny_cfg(LSTM + NO_DROPOUT + ["SOLVER.OPTIMIZER", optimizer]))
    batch, targets = port_batch(clip_arrays())

    def train_state():
        model = build_model(cfg, device="cpu", seed=0)
        opt = make_optimizer(cfg, model, num_training_steps=10)
        return create_train_state(cfg, model, opt), make_train_step(cfg, model, opt, device="cpu")

    old, old_step = train_state()
    inputs = [p for n, p in old.model.named_parameters() if n.endswith("bias_ih_l0")]
    for p in inputs:
        p.requires_grad_(True)
    old_step(old, batch, targets)
    assert all(p.abs().max() > 0 for p in inputs)
    Checkpointer(str(tmp_path)).save(1, old, block=True)

    new, new_step = train_state()
    Checkpointer(str(tmp_path)).restore(new)
    encoders = old.model.text_encoder.eval(), new.model.text_encoder.eval()
    with torch.no_grad():
        (f0, c0), (f1, c1) = (e(batch.token_ids, batch.token_valid) for e in encoders)
    torch.testing.assert_close(f1, f0, rtol=0, atol=1e-6)
    torch.testing.assert_close(c1, c0, rtol=0, atol=1e-6)
    named = dict(new.model.named_parameters())
    input_names = [n for n in named if n.endswith("bias_ih_l0")]
    for n in input_names:
        assert torch.equal(named[n], torch.zeros_like(named[n])), n
    new_step(new, batch, targets)
    for n in input_names:
        assert torch.equal(named[n].detach(), torch.zeros_like(named[n])), n


def test_lstm_variant_serves():
    """GroundingPredictor with MODEL.USE_LSTM: a box for every frame id,
    finite, and a span inside the clip."""
    from stcat_tpu_torch.serve import GroundingPredictor

    cfg = port_cfg(tiny_cfg(LSTM + ["INPUT.RESOLUTION", 64, "INPUT.MAX_QUERY_LEN", 8,
                                    "TPU.FRAME_BUCKETS", "[8]"]))
    pred = GroundingPredictor(cfg, max_batch=2, device="cpu")
    clip = np.random.RandomState(0).randint(0, 255, (12, 48, 64, 3), dtype=np.uint8)
    res = pred.predict(clip, "a person waves at the camera")
    assert sorted(res["boxes"]) == list(range(12))
    assert np.isfinite(np.asarray(list(res["boxes"].values()))).all()
    assert 0 <= res["span"][0] < res["span"][1] <= 12
