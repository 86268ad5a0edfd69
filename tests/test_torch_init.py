"""The port's fresh weights against the JAX package's initial draw, on the CPU.

The JAX package initialises the tiny model (``jax.random.PRNGKey``); its
variables go through ``from_jax_variables`` into the port's names; the port
draws its own with ``build_model(..., device="cpu")``. The two draws come
from other generators, so the samples differ; each leaf's distribution must
not. Per leaf that is not constant:

- the std ratio port / JAX lies within 1 +- 6 / sqrt(2n) (about 4 sigma of
  the ratio of two sample stds of n draws each);
- the support: max |w| / std no larger than the family's bound (2 / 0.8796
  = 2.27 for flax's truncated normal, sqrt(3) = 1.73 for the uniform) times
  1 + 3 / sqrt(n) for the sample std's own spread, on both samples (so the
  family map below is held to the JAX draw too); a uniform[0, 1) table
  lies in [0, 1);
- the two-sample Kolmogorov-Smirnov statistic below its critical value
  c sqrt((n + m) / (n m)) at alpha = 1e-3 for the whole model: 1e-3 / N
  per leaf for N random leaves (Bonferroni; c = 2.49 for N = 124). At 1e-3
  per leaf a correct draw failed one of ~120 leaves in one of six seeds.

Every constant leaf (zeros, ones, FrozenBN buffers) is equal. The family
of each leaf is read from the JAX package's modules (``kernel_init=xavier``
in ``models/decoder.py`` and ``models/encoder.py``, ``nn.Embed``, the
learned tokens and tables, the LSTM's orthogonal recurrent kernels; every
other kernel is flax's default, lecun-normal).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from stcat_tpu.core.batch import VideoBatch as JBatch
from stcat_tpu.models import STCATNet as JNet
from stcat_tpu.models.decoder import MLP as JMLP, SpatialDecoder as JSpatialDecoder
from stcat_tpu.models.encoder import TransformerEncoderLayer as JEncoderLayer
from test_torch_model import _batch_arrays, port_cfg

from stcat_tpu_torch.convert import Writer, from_jax_variables, spatial_decoder
from stcat_tpu_torch.models import build_model, init_parameters
from stcat_tpu_torch.models.decoder import SpatialDecoder
from stcat_tpu_torch.models.encoder import TransformerEncoderLayer

KS_ALPHA = 1e-3  # for all of one comparison's random leaves together
TRUNCATED_BOUND = 2.0 / 0.87962566103423978     # flax's truncated normal, in stds
UNIFORM_BOUND = float(np.sqrt(3.0))

# the JAX package's kernel_init=xavier layers, by port name: the decoders'
# _dense projections and FFNs, the template generator, every MLP, the
# encoder's FFN
XAVIER = re.compile(
    r"((^|\.)(sa|ca)_\w+_proj|(^|\.)linear[12]|template_generator\.\w+"
    r"|(query_scale|ref_point_head|bbox_embed|temp_embed|action_embed)\.layers\.\d+)\.weight$")
NORMAL = re.compile(r"(embeddings?|frame_cls|video_cls|local_pos_embed|time_embed\.embed)\.weight$")
UNIFORM01 = re.compile(r"(row|col)_embed\.weight$")
ORTHOGONAL = re.compile(r"weight_hh_l0$")


def family(name: str) -> str:
    for fam, pattern in (("xavier", XAVIER), ("uniform01", UNIFORM01), ("normal", NORMAL),
                         ("orthogonal", ORTHOGONAL)):
        if pattern.search(name):
            return fam
    return "truncated"


def ks_statistic(a: np.ndarray, b: np.ndarray) -> float:
    """sup |F_a - F_b| of the two empirical distribution functions."""
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    fa = np.searchsorted(a, grid, side="right") / a.size
    fb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.abs(fa - fb).max())


def compare_draws(ours: dict, theirs: dict) -> dict:
    """Per-leaf readings and failures of the port's draw against the JAX
    draw (both {name: ndarray} in the port's layout)."""
    assert set(ours) == set(theirs), sorted(set(ours) ^ set(theirs))
    readings, failures = {}, []
    random_leaves = sum(v.min() != v.max() for v in theirs.values())
    ks_c = np.sqrt(-np.log(KS_ALPHA / random_leaves / 2) / 2)
    for name in sorted(theirs):
        a, b = ours[name].astype(np.float64).ravel(), theirs[name].astype(np.float64).ravel()
        assert a.shape == b.shape, name
        if b.min() == b.max():
            if not np.array_equal(a, b):
                failures.append(f"{name}: constant leaf {b[0]} drawn as {a[:4]}...")
            continue
        n, fam = a.size, family(name)
        ratio = a.std() / b.std()
        ks = ks_statistic(a, b)
        ks_limit = ks_c * np.sqrt(2.0 / n)
        support = {"port": np.abs(a).max() / a.std(), "jax": np.abs(b).max() / b.std()}
        readings[name] = dict(n=n, family=fam, std_ratio=ratio, ks=ks, ks_limit=ks_limit,
                              support=support["port"], jax_support=support["jax"])
        if not abs(ratio - 1.0) <= 6.0 / np.sqrt(2 * n):
            failures.append(f"{name} ({fam}, n={n}): std ratio {ratio:.4f}")
        if not ks <= ks_limit:
            failures.append(f"{name} ({fam}, n={n}): KS {ks:.4f} > {ks_limit:.4f}")
        bound = {"truncated": TRUNCATED_BOUND, "xavier": UNIFORM_BOUND}.get(fam)
        for side, x in (("port", a), ("jax", b)):
            if bound is not None and not support[side] <= bound * (1 + 3 / np.sqrt(n)):
                failures.append(f"{name} ({fam}, n={n}): {side} max|w|/std "
                                f"{support[side]:.3f} > {bound:.3f}")
            if fam == "uniform01" and not (x.min() >= 0.0 and x.max() < 1.0):
                failures.append(f"{name}: {side} outside [0, 1)")
    return dict(readings=readings, failures=failures)


def _assert_matches(result: dict) -> None:
    readings = result["readings"]
    worst = sorted(readings.items(), key=lambda kv: -abs(kv[1]["std_ratio"] - 1))[:3]
    print(f"{len(readings)} random leaves; std ratio port/JAX furthest from 1: "
          + ", ".join(f"{n} {r['std_ratio']:.4f}" for n, r in worst)
          + f"; port max|w|/std up to {max(r['support'] for r in readings.values()):.3f}")
    assert not result["failures"], (f"{len(result['failures'])} failures:\n"
                                     + "\n".join(result["failures"]))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("extra", [
    pytest.param([], id="default"),
    pytest.param(["MODEL.STCAT.FROM_SCRATCH", "false", "MODEL.VISION_BACKBONE.POS_ENC", "learned",
                  "MODEL.STCAT.USE_LEARN_TIME_EMBED", "true"], id="pretrained_learned"),
    pytest.param(["MODEL.STCAT.QUERY_DIM", "2"], id="query_dim_2"),
    pytest.param(["MODEL.USE_LSTM", "true", "MODEL.LSTM.HIDDEN_SIZE", 64,
                  "MODEL.LSTM.EMBED_DIM", 48], id="lstm"),
])
def test_fresh_weights_follow_the_jax_distributions(extra):
    jcfg = tiny_cfg(extra)
    arrays = _batch_arrays(b=2, t=6, h=32, w=32, l=7, seed=0)
    jbatch = JBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    seed = int(np.random.RandomState(0).randint(2**31))
    variables = jax.jit(JNet(jcfg).init)(jax.random.PRNGKey(seed), jbatch)
    theirs = {k: v.numpy() for k, v in from_jax_variables(
        _numpy(variables["params"]), _numpy(variables["constants"])).items()}
    model = build_model(port_cfg(jcfg), device="cpu", seed=seed)
    ours = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    _assert_matches(compare_draws(ours, theirs))


def test_recipe_width_layers_follow_the_jax_distributions():
    """One encoder layer and a two-layer spatial decoder (the second makes
    query_scale) at the recipe's
    widths (d 256, 8 heads, FFN 2048) on both sides. linear1's std is
    JAX's to 1 +- 0.03 in each (the port's untruncated 1 / sqrt(256) drew
    2.12x xavier's sqrt(2 / 2304) there)."""
    d, heads, ffn, b, t, m = 256, 8, 2048, 1, 2, 3
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(b, 5, d).astype(np.float32))
    enc_vars = jax.jit(JEncoderLayer(d, heads, ffn).init)(
        jax.random.PRNGKey(1), x, x, jnp.ones((b, 5), bool))
    anchors = jnp.asarray(rng.uniform(0.2, 0.8, (b, t, 4)).astype(np.float32))
    memory = jnp.asarray(rng.randn(b, t, m, d).astype(np.float32))
    dec = JSpatialDecoder(d, heads, ffn, 2, bbox_embed=JMLP(d, 4, 3))
    dec_vars = jax.jit(dec.init)(jax.random.PRNGKey(2), anchors, memory,
                                 jnp.ones((b, t, m), bool), memory, memory[:, :, 0],
                                 jnp.ones((b, t), bool))
    w = Writer()
    w.encoder_layer("encoder", _numpy(enc_vars["params"]))
    spatial_decoder(w, _numpy(dec_vars["params"]), "decoder.")
    theirs = {k: v.numpy() for k, v in w.sd.items()}

    ours_mod = torch.nn.ModuleDict({"encoder": TransformerEncoderLayer(d, heads, ffn),
                                    "decoder": SpatialDecoder(d, heads, ffn, 2)})
    init_parameters(ours_mod, torch.Generator().manual_seed(1))
    ours = {k: v.detach().numpy() for k, v in ours_mod.state_dict().items()}
    result = compare_draws(ours, theirs)
    for name in ("encoder.linear1.weight", "decoder.layers.0.linear1.weight"):
        ratio = result["readings"][name]["std_ratio"]
        assert abs(ratio - 1.0) <= 0.03, (name, ratio)
    _assert_matches(result)
