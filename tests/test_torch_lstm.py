"""The MODEL.USE_LSTM text variant against the JAX package's, on the CPU.

``LSTMTextEncoder`` against the JAX one with the JAX weights carried by
``convert.lstm_text`` (bi- and unidirectional, one and two layers, ragged
lengths down to 1, every position including the pads) at atol 2e-5; the
GloVe table; a tiny STCATNet with the LSTM against the JAX model at atol
2e-4 / rtol 1e-3 (tests/test_full_parity.py's tolerance), weights through
``from_jax_variables``; then that the variant trains (its gradients reach
the LSTM, in the text group) and serves.
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
from test_torch_train import NO_DROPOUT, clip_arrays, port_batch

from stcat_tpu_torch.convert import Writer, from_jax_variables, lstm_text
from stcat_tpu_torch.core.batch import VideoBatch as PBatch
from stcat_tpu_torch.models import STCATNet as PNet, build_model
from stcat_tpu_torch.models.lstm_text import LSTMTextEncoder
from stcat_tpu_torch.train.optimizer import make_optimizer
from stcat_tpu_torch.train.step import create_train_state, make_train_step

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


def test_lstm_variant_trains():
    """Two train steps of the variant: finite losses, every LSTM weight in
    the text group with a gradient and moved, TEXT_MODEL.FREEZE leaving the
    LSTM trainable (it freezes only a RoBERTa body, as in the JAX labels)."""
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
    assert [n for n in lstm if not torch.equal(named[n].detach(), before[n])] == lstm


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
