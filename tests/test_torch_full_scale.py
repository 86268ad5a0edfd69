"""The port against the JAX package at the published scale, on the CPU.

tests/test_full_scale_parity.py holds the JAX package to the reference at the
published depth and widths (ResNet-101 3-4-23-3, RoBERTa-base, 6/6/6 layers
at d 256), where naming or shape faults that only exist at real depth cannot
hide; every other port test runs tiny widths. Here the port is held to the
JAX package at that scale, with the seeded weights and inputs of
tests/torch_full_scale.py: the parameter layout against JAX's own template,
the MDETR remap at full shape, the served forward (raw outputs, per-frame
boxes, spans) and one train step (loss terms, every parameter's gradient),
each against a fresh JAX run (TPU.ATTENTION_IMPL and TPU.CONV_IMPL "xla",
the plain references of the Pallas kernels; the port's wrappers run their
plain versions on CPU tensors). A planted fault in a layer only the full
depth has must fail the forward comparison. The committed fixture that
chip_smoke.py phase 11 holds the card to is checked against the seeded
helpers here, and (slow) rebuilt and held to the committed one, with the
port's served batch at the recipe's 448 px and 32-frame bucket held to it.
Tolerances: tests/torch_full_scale.py (ATOL, RTOL, LOSS_RTOL, GRAD_RTOL,
GRAD_FLOOR); each test prints its largest reading beside its limit.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_full_scale as fs
from stcat_tpu.core.batch import VideoBatch as JBatch
from stcat_tpu.models import STCATNet as JNet
from stcat_tpu.train.convert_reference import (
    convert_reference_stcat, merge_partial, remap_mdetr as jax_remap_mdetr,
)

from stcat_tpu_torch.convert import from_jax_variables
from stcat_tpu_torch.models import build_model
from stcat_tpu_torch.serve import GroundingPredictor
from stcat_tpu_torch.train.convert_reference import load_reference_state_dict, remap_mdetr

_spec = importlib.util.spec_from_file_location(
    "torch_full_scale_fixture", os.path.join(fs.ROOT, "scripts", "torch_full_scale_fixture.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

# Under pytest-xdist the workers share the machine's cores (see
# tests/test_torch_train.py)
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The seeded weight set and a .pth of it."""
    sd = fs.weight_set()
    path = str(tmp_path_factory.mktemp("full_scale") / "weights.pth")
    torch.save(sd, path)
    return sd, path


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = tuple(v.shape)
    return out


def test_layout_matches_the_jax_template(weights):
    """The port's STCATNet at the published scale has exactly the names and
    shapes that from_jax_variables makes of JAX's own init template, and
    JAX's converter takes every one of them into that template's shapes."""
    sd, _ = weights
    jcfg = fx.jax_cfg()
    t, hw, lq = 2, 64, jcfg.INPUT.MAX_QUERY_LEN
    batch = JBatch(frames=jnp.zeros((1, t, hw, hw, 3)), frame_valid=jnp.ones((1, t), bool),
                   pixel_valid=jnp.ones((1, t, hw, hw), bool),
                   token_ids=jnp.zeros((1, lq), jnp.int32), token_valid=jnp.ones((1, lq), bool))
    template = jax.eval_shape(JNet(jcfg).init, jax.random.PRNGKey(0), batch)

    def zeros(tree):
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), tree)

    from_jax = {k: tuple(v.shape) for k, v in from_jax_variables(
        zeros(template["params"]), zeros(template["constants"])).items()}
    port = {k: tuple(v.shape) for k, v in fs.meta_model().state_dict().items()}
    assert port == from_jax, (sorted(set(port) ^ set(from_jax))[:8],
                              [(k, port[k], from_jax[k]) for k in port
                               if k in from_jax and port[k] != from_jax[k]][:8])
    print(f"\n{len(port)} state_dict entries, {sum(np.prod(s) for s in port.values()) / 1e6:.1f} M "
          "values: the port's names and shapes equal from_jax_variables of JAX's template")

    params, consts, unused = convert_reference_stcat(sd, jcfg)
    assert unused == set()
    assert _flat_shapes(params) == _flat_shapes(template["params"])
    assert _flat_shapes(consts) == _flat_shapes(template["constants"])
    for key, shape in (
            ("vis_encoder.0.body.layer3.22.conv2.weight", (256, 256, 3, 3)),
            ("vis_encoder.0.body.layer4.2.conv3.weight", (2048, 512, 1, 1)),
            ("text_encoder.body.encoder.layer.11.output.dense.weight", (768, 3072)),
            ("text_encoder.body.pooler.dense.weight", (768, 768)),
            ("text_encoder.body.embeddings.position_embeddings.weight", (514, 768)),
            ("text_encoder.body.embeddings.word_embeddings.weight", (50265, 768)),
            ("text_encoder.resizer.fc.weight", (256, 768)),
            ("ground_encoder.encoder.spatial_layers.5.linear1.weight", (2048, 256)),
            ("ground_decoder.decoder.layers.5.ca_qpos_sine_proj.weight", (256, 256)),
            ("ground_decoder.temp_decoder.layers.5.cross_attn_image.in_proj_weight", (768, 256)),
            ("ground_decoder.temp_decoder.layers.5.linear2.weight", (256, 2048))):
        assert port[key] == shape, (key, port[key])
    assert "vis_encoder.0.body.layer3.23.conv1.weight" not in port


def _mdetr(sd):
    """A full-shape MDETR state_dict: the reference names inverse-mapped as
    tests/test_full_scale_parity.py builds one."""
    inverse = [("vis_encoder.", "backbone."), ("text_encoder.body.", "transformer.text_encoder."),
               ("text_encoder.resizer.", "transformer.resizer."),
               ("ground_encoder.encoder.spatial_layers.", "transformer.encoder.layers."),
               ("ground_decoder.decoder.", "transformer.decoder.")]
    out = {}
    for k, v in sd.items():
        for ours, theirs in inverse:
            if k.startswith(ours):
                out[theirs + k[len(ours):]] = v
                break
        else:
            if k.startswith(("input_proj.", "bbox_embed.")):
                out[k] = v
    return out


def test_mdetr_remap_matches_jax(weights):
    """Both packages' MDETR partial init at full shape: the port's remap and
    load_reference_state_dict(strict=False) load exactly the entries JAX's
    remap_mdetr + convert_reference_stcat(strict=False) + merge_partial
    overwrite, with the same values (FrozenBN scales within an ulp: JAX folds
    them in float64)."""
    sd, _ = weights
    mdetr = _mdetr(sd)
    assert any(k.startswith("backbone.0.body.layer3.22.") for k in mdetr)
    assert any(k.startswith("transformer.encoder.layers.5.") for k in mdetr)
    assert any(k.startswith("transformer.text_encoder.encoder.layer.11.") for k in mdetr)
    remapped = remap_mdetr(mdetr)
    assert remapped.keys() == jax_remap_mdetr(mdetr).keys()

    jcfg = fx.jax_cfg()
    model = fs.meta_model().to_empty(device="cpu")
    loaded = set(load_reference_state_dict(model, remapped, strict=False))
    partial, partial_consts, _ = convert_reference_stcat(jax_remap_mdetr(mdetr), jcfg, strict=False)
    nan = {}
    for name, tree in zip(("params", "constants"), convert_reference_stcat(sd, jcfg)[:2]):
        nan[name] = jax.tree_util.tree_map(lambda a: np.full(np.shape(a), np.nan, np.float32),
                                           tree)
    merged = from_jax_variables(merge_partial(nan["params"], partial),
                                merge_partial(nan["constants"], partial_consts))
    # from_jax_variables writes FrozenBN's mean and var itself: read a norm's
    # coverage from its folded scale
    covered = {k for k, v in merged.items() if not torch.isnan(v).any()
               and not k.endswith(("running_mean", "running_var"))}
    assert covered == {k for k in loaded if not k.endswith(("running_mean", "running_var"))}
    assert {k.rsplit(".", 1)[0] for k in loaded if k.endswith("running_var")} <= {
        k.rsplit(".", 1)[0] for k in covered}
    own = model.state_dict()
    for k in sorted(loaded):
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(own[k], sd[k]), k
        elif (".bn" in k or "downsample.1" in k) and k.endswith(".weight"):
            torch.testing.assert_close(own[k], merged[k], rtol=2e-7, atol=0, msg=k)
        else:
            assert torch.equal(own[k], merged[k]), k
    sections = {k.split(".")[0] for k in loaded}
    assert sections == {"vis_encoder", "input_proj", "text_encoder", "ground_encoder",
                        "ground_decoder", "bbox_embed"}, sections
    print(f"\nMDETR remap: {len(loaded)} of {len(own)} entries loaded alike in both packages")


@pytest.fixture(scope="module")
def jax_small(weights):
    """JAX's GroundingPredictor on the tier-1 request: (answers, raw outputs)."""
    _, path = weights
    cfg = fx.jax_cfg()
    pred = fx.predictor(cfg, path, max_batch=len(fs.SMALL))
    results, batch = fx.serve(pred, fs.requests(fs.SMALL))
    return (fs.answers(results, batch.frame_valid),
            fx.raw_outputs(cfg, pred.params, pred.constants, batch))


@pytest.fixture(scope="module")
def port_small(weights):
    _, path = weights
    return GroundingPredictor(fs.full_cfg(), weights=path, max_batch=len(fs.SMALL), device="cpu")


def _report(errs, label):
    worst = max(errs.items(), key=lambda kv: kv[1][1])
    print(f"\n{label}: {len(errs)} outputs, largest |d| {max(e for e, _ in errs.values()):.3e}; "
          f"worst {worst[0]} at {worst[1][1]:.4f} x the limit (atol {fs.ATOL}, rtol {fs.RTOL})")
    return worst[1][1]


def _assert_answers(got_answers, want_answers, got, want):
    misses, notes = fs.answer_misses(got_answers, want_answers, got["pred_sted"],
                                     want["pred_sted"])
    rows = fs.span_rows(got["pred_sted"], want["pred_sted"], want_answers["frame_valid"])
    print("spans per forward row (JAX span, margin, port span, |d sted|): " + "; ".join(
        f"{r[0]} {r[1]:.3e} {r[2]} {r[3]:.3e}" for r in rows) + "".join(
        f"\n  note: {n}" for n in notes))
    assert misses == []


def test_served_request_matches_jax(jax_small, port_small):
    """One 7-frame request (streams of 4 and 3 frames, the second padded) at
    the recipe's 448 px through both predictors: every raw output within
    atol 5e-4 / rtol 1e-3, the per-frame boxes too, the span equal."""
    want_answers, want = jax_small
    with fs.stage_rms(port_small.model) as rms:
        got_answers, got = fs.serve(port_small, fs.requests(fs.SMALL))
    print("\nstage rms: " + ", ".join(f"{k} {v:.3f}" for k, v in rms.items()))
    assert _report(fs.output_errors(got, want), "served forward, port vs JAX") <= 1.0
    _assert_answers(got_answers, want_answers, got, want)
    assert len(got_answers["request_0/frame_ids"]) == fs.SMALL[0][0]


def test_planted_full_depth_fault_fails_the_comparison(jax_small, port_small):
    """layer3.22's 3x3 kernel flipped in space: a layer no tiny config has.
    The comparison of the test above must fail on it."""
    want_answers, want = jax_small
    w = port_small.model.state_dict()["vis_encoder.0.body.layer3.22.conv2.weight"]
    with torch.no_grad():
        w.copy_(torch.flip(w, (2, 3)))
    try:
        got_answers, got = fs.serve(port_small, fs.requests(fs.SMALL))
    finally:
        with torch.no_grad():
            w.copy_(torch.flip(w, (2, 3)))
    assert _report(fs.output_errors(got, want), "planted fault (layer3.22.conv2 flipped)") > 1.0


def test_train_step_matches_jax(weights):
    """One fp32 train step (loss and gradients, GRAD_ACCUM 1) on one 16-frame
    clip at 224 px: every loss term within rel LOSS_RTOL of JAX's; every
    parameter's gradient norm and projection on a seeded unit direction
    within GRAD_RTOL x max(its JAX norm, GRAD_FLOOR x its group's norm).
    Frozen parameters (the stem, layer1) and the unused RoBERTa pooler get
    no gradient in the port and a zero one in JAX."""
    sd, _ = weights
    jcfg = fx.jax_cfg(train=True)
    params, consts, _ = convert_reference_stcat(sd, jcfg)
    raw, targets = fx.train_inputs(jcfg)
    terms, grads = fx.train_step(jcfg, params, consts, raw, targets)
    del params, consts
    arrays = {f"train/loss/{k}": np.float64(v) for k, v in terms.items()}
    arrays.update({f"train/grad/{k}": v for k, v in fx.grad_readings(grads).items()})

    cfg = fs.train_cfg()
    model = build_model(cfg, "cpu")
    load_reference_state_dict(model, sd)
    got_terms, readings = fs.train_step(cfg, model, fs.grad_directions())
    (loss_r, loss_k), (leaf_r, leaf_k, which), misses = fs.train_errors(got_terms, readings, arrays)
    print(f"\ntrain step: loss {got_terms['loss']:.6f} (JAX {terms['loss']:.6f}); worst loss term "
          f"{loss_k} at {loss_r:.4f} x rel {fs.LOSS_RTOL}; worst gradient {leaf_k} ({which}) at "
          f"{leaf_r:.4f} x its limit")
    assert misses == []
    no_grad = [k for k, r in readings.items() if not r.any()]
    assert no_grad and all(not grads[k].any() for k in no_grad)
    assert "text_encoder.body.pooler.dense.weight" in no_grad


def test_fixture_matches_the_seeded_helpers(weights):
    """The committed JAX fixture was made from these helpers' weights (the
    checksum), cuts and inputs, and stays under 1 MB."""
    sd, _ = weights
    arrays, meta = fs.load_fixture()
    assert meta["weights_sha256"] == fs.checksum(sd)
    assert meta["seed"] == fs.SEED and meta["opts"] == list(fs.OPTS) and meta["cuts"] == fs.CUTS
    assert meta["served"] == [list(r) for r in fs.SERVED]
    size = sum(os.path.getsize(os.path.join(fs.FIXTURE, f)) for f in os.listdir(fs.FIXTURE))
    assert size < 2**20, size
    params = dict(fs.meta_model(fs.train_cfg()).named_parameters())
    assert {k[len("train/grad/"):] for k in arrays if k.startswith("train/grad/")} == set(params)
    for r in range(len(fs.SERVED)):
        assert arrays[f"serve/request_{r}/boxes"].shape == (fs.SERVED[r][0], 4)
    lanes = 2 * len(fs.SERVED)
    assert arrays["serve/pred_boxes"].shape == (lanes, 32, 4)
    assert arrays["serve/frame_valid"].sum(1).tolist() == (
        [(t + 1) // 2 for t, _ in fs.SERVED] + [t // 2 for t, _ in fs.SERVED])
    for dtype in ("bf16", "bf16_strict"):
        assert fs.fixture_outputs(arrays, f"{dtype}/").keys() == fs.fixture_outputs(arrays).keys()


def test_chip_phase_runs_the_recipe_without_jax():
    """chip_smoke.py phase 11 runs the script's recipe_cfg with every dropout
    0, the hash tokenizer and the cut frame buckets, and the script with
    tests/torch_full_scale.py imports no JAX (the card machine has none)."""
    code = (
        "import sys\n"
        "sys.path[:0] = ['.', 'tests']\n"
        "import chip_smoke, torch_full_scale as fs\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'orbax', 'stcat_tpu'))\n"
        "assert not bad, bad\n"
        "assert fs.full_cfg() == chip_smoke.recipe_cfg(*fs.OPTS[6:], 'TPU.COMPUTE_DTYPE', "
        "'float32')\n"
        "assert fs.OPTS[:6] == ('MODEL.WEIGHT', '', 'TPU.CONV_IMPL', 'pallas', "
        "'TPU.CONV_STAGES', '[1,2,3,4]')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=fs.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.fixture(scope="module")
def fresh_fixture(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fixture"))
    fx.build(out)
    return fs.load_fixture(out)


@pytest.mark.slow
def test_fixture_is_current(fresh_fixture):
    """The fixture rebuilt with JAX equals the committed one within 1e-6."""
    fresh, fresh_meta = fresh_fixture
    arrays, meta = fs.load_fixture()
    assert fresh.keys() == arrays.keys()
    assert fresh_meta["weights_sha256"] == meta["weights_sha256"]
    worst = max((float(np.abs(np.asarray(fresh[k], np.float64) - arrays[k]).max()), k)
                for k in arrays)
    print(f"\nrebuilt fixture: largest |d| {worst[0]:.3e} ({worst[1]}), limit 1e-6")
    assert worst[0] <= 1e-6


@pytest.mark.slow
def test_served_batch_matches_jax(fresh_fixture, weights):
    """The served batch (two requests, 4 lanes of a 32-frame bucket, the
    second request's streams padded) at 448 px through the port's predictor
    against the fresh JAX run: raw outputs, boxes and spans as in the tier-1
    test."""
    arrays, _ = fresh_fixture
    _, path = weights
    pred = GroundingPredictor(fs.full_cfg(), weights=path, max_batch=len(fs.SERVED),
                              device="cpu")
    got_answers, got = fs.serve(pred, fs.requests(fs.SERVED))
    assert _report(fs.output_errors(got, fs.fixture_outputs(arrays)),
                   "served batch, port vs JAX") <= 1.0
    want = fs.fixture_outputs(arrays)
    _assert_answers(got_answers, fs.fixture_answers(arrays), got, want)
