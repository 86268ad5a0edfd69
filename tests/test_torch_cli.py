"""The port's evaluation, conversion, inference, serving and reproduction
CLIs against the building blocks they wire together, on the CPU.

Every CLI runs in-process through ``main(argv)`` with ``--device cpu`` at
tests/test_cli.py's tiny widths (fp32) on the synthetic dataset. The blocks
themselves (``do_eval``, ``load_reference_state_dict``,
``GroundingPredictor``) are held against the JAX package in
tests/test_torch_{eval,loop,serve}.py; here each CLI must give exactly what
its blocks give. ``load_frames`` is held against the JAX CLI's.
"""

import concurrent.futures
import http.client
import io
import json
import os

import numpy as np
import pytest
import torch

from test_cli import TINY_OPTS

from stcat_tpu_torch.cli import convert as pconvert
from stcat_tpu_torch.cli import infer as pinfer
from stcat_tpu_torch.cli import load_config
from stcat_tpu_torch.cli import repro as prepro
from stcat_tpu_torch.cli import serve as pserve
from stcat_tpu_torch.cli import test as ptest
from stcat_tpu_torch.data.loader import make_loader
from stcat_tpu_torch.data.synthetic import make_synthetic_dataset, render_frames
from stcat_tpu_torch.eval.engine import do_eval
from stcat_tpu_torch.eval.evaluator import build_evaluator
from stcat_tpu_torch.models import build_model
from stcat_tpu_torch.serve import GroundingPredictor
from stcat_tpu_torch.train.checkpoint import Checkpointer, load_weights_for_eval
from stcat_tpu_torch.train.convert_reference import load_reference_state_dict, remap_mdetr
from stcat_tpu_torch.train.optimizer import make_optimizer
from stcat_tpu_torch.train.step import create_train_state

HASH_OK = ["MODEL.TEXT_MODEL.ALLOW_HASH_TOKENIZER", "true"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The synthetic test split under DATA_DIR and a training run's
    checkpoint directory (seed-1 weights, perturbed EMA) to evaluate."""
    root = tmp_path_factory.mktemp("cli")
    opts = ["DATA_DIR", str(root / "data"), "OUTPUT_DIR", str(root / "out")] + TINY_OPTS
    cfg = load_config("", opts)
    make_synthetic_dataset(cfg, "test")
    model = build_model(cfg, device="cpu", seed=1)
    state = create_train_state(cfg, model, make_optimizer(cfg, model, num_training_steps=4))
    gen = torch.Generator().manual_seed(2)
    for p in state.ema.values():
        p.add_(torch.randn(p.shape, generator=gen) * 1e-2)
    Checkpointer(str(root / "run")).save(3, state, block=True)
    return root, opts, cfg


def _eval_with(cfg, weight):
    model = build_model(cfg, device="cpu", seed=cfg.SEED)
    load_weights_for_eval(model, weight)
    loader = make_loader(cfg, make_synthetic_dataset(cfg, "test"), "test")
    return do_eval(cfg, model, loader, build_evaluator(cfg, None, "test"))


def test_cli_test_equals_do_eval_and_writes_results(setup):
    """cli.test --synthetic on a run's checkpoint directory: the metrics of
    do_eval over the same loader and weights, exactly; test_results.json
    lands in OUTPUT_DIR."""
    root, opts, cfg = setup
    run = str(root / "run")
    res = ptest.main(["--synthetic", "--device", "cpu"] + opts + ["MODEL.WEIGHT", run])
    assert res == _eval_with(cfg, run)
    assert any(k.endswith("_viou") for k in res) and all(0.0 <= v <= 1.0 for v in res.values())
    with open(root / "out" / "test_results.json") as f:
        assert json.load(f)


@pytest.mark.parametrize("kind", ["reference", "mdetr"])
def test_convert_writes_what_the_loaders_read(setup, tmp_path, kind):
    """cli.convert of a reference-shaped .pth (tests/test_convert_reference.py's
    synthetic state_dict, under MDETR's names for the partial init): the
    directory loads into a model equal to load_reference_state_dict of the
    same file over a fresh SEED model, EMA included, and provenance.json
    carries the JAX CLI's keys. Training cannot resume from it."""
    from test_convert_reference import ref_state_dict
    from test_torch_loop import _to_mdetr

    from stcat_tpu.config import default_config, merge_from_list

    _, opts, cfg = setup
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in ref_state_dict(merge_from_list(default_config(), TINY_OPTS),
                                     np.random.RandomState(0)).items()}
    if kind == "mdetr":  # MDETR's names for the sections it has, and an MDETR-only key
        sd = {**_to_mdetr(sd), "transformer.contrastive_align.weight": torch.zeros(3)}
    src, out = str(tmp_path / "src.pth"), str(tmp_path / "ck")
    torch.save({"model": sd}, src)
    pconvert.main(["--src", src, "--out", out, "--device", "cpu"] + opts)

    want = build_model(cfg, device="cpu", seed=cfg.SEED)
    load_reference_state_dict(want, remap_mdetr(sd) if kind == "mdetr" else sd,
                              strict=kind != "mdetr")
    got = build_model(cfg, device="cpu", seed=5)
    load_weights_for_eval(got, out)
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    payload = torch.load(os.path.join(out, "checkpoints", "model_00000000.pt"))
    assert payload["step"] == 0 and payload["optimizer"] is None
    assert payload["ema"].keys() == dict(want.named_parameters()).keys()
    with open(os.path.join(out, "provenance.json")) as f:
        assert json.load(f) == {"converted_from_reference": True, "src": src,
                                "mdetr_partial_init": kind == "mdetr"}
    state = create_train_state(cfg, got, make_optimizer(cfg, got, num_training_steps=4))
    with pytest.raises(ValueError, match="without optimizer state"):
        Checkpointer(out).restore(state)


def test_converted_checkpoint_is_guarded_and_evaluates(setup, tmp_path):
    """A converted directory is reference-derived: cli.test and the predictor
    refuse it under the hash tokenizer (tests/test_tokenizer_guard.py's rule)
    and take it with ALLOW_HASH_TOKENIZER, giving do_eval's metrics."""
    root, opts, cfg = setup
    src, out = str(tmp_path / "src.pth"), str(tmp_path / "ck")
    torch.save(build_model(cfg, device="cpu", seed=3).state_dict(), src)
    pconvert.main(["--src", src, "--out", out, "--device", "cpu"] + opts)
    with pytest.raises(RuntimeError, match="HASH tokenizer"):
        ptest.main(["--synthetic", "--device", "cpu"] + opts + ["MODEL.WEIGHT", out])
    with pytest.raises(RuntimeError, match="HASH tokenizer"):
        GroundingPredictor(cfg, weights=out, device="cpu")
    res = ptest.main(["--synthetic", "--device", "cpu"] + opts + ["MODEL.WEIGHT", out] + HASH_OK)
    assert res == _eval_with(load_config("", opts + HASH_OK), out)


def _clip(t=10, h=48, w=64, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (t, h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def frame_dir(setup):
    """A rendered clip written as JPEGs, the datasets' frame-directory layout."""
    from PIL import Image

    root, _, _ = setup
    d = root / "frames"
    d.mkdir()
    item = {"height": 48, "width": 64, "gt_temp_bound": [2, 5], "vid": "clip",
            "bboxs": [[10 + k, 8, 30 + k, 28] for k in range(4)]}
    for fid, img in enumerate(render_frames(item, range(9))):
        Image.fromarray(img).save(str(d / f"img_{fid:05d}.jpg"), quality=90)
    return str(d)


def test_load_frames_matches_the_jax_cli(frame_dir, tmp_path):
    """A frame directory, a .npy, a stride, floats in [0, 1]: the same frames
    and frame ids as the JAX CLI's load_frames; each refusal raises the
    same SystemExit."""
    from stcat_tpu.cli.infer import load_frames as jload

    floats = str(tmp_path / "f.npy")
    np.save(floats, _clip(seed=1).astype(np.float32) / 255.0)
    u8 = str(tmp_path / "u8.npy")
    np.save(u8, _clip(seed=2))
    for path, stride in ((frame_dir, 1), (frame_dir, 2), (u8, 1), (u8, 3), (floats, 2)):
        (a, ai), (b, bi) = pinfer.load_frames(path, stride), jload(path, stride)
        assert a.dtype == b.dtype == np.uint8 and ai == bi
        np.testing.assert_array_equal(a, b)
    bad = {"wide": np.full((2, 4, 4, 3), 300, np.int32), "rank": np.zeros((4, 4, 3), np.uint8),
           "range": np.full((2, 4, 4, 3), 2.0, np.float32)}
    empty = tmp_path / "empty"
    empty.mkdir()
    cases = [(str(empty), 1), (u8, 0)]
    for name, arr in bad.items():
        np.save(str(tmp_path / f"{name}.npy"), arr)
        cases.append((str(tmp_path / f"{name}.npy"), 1))
    for path, stride in cases:
        with pytest.raises(SystemExit) as ours:
            pinfer.load_frames(path, stride)
        with pytest.raises(SystemExit) as theirs:
            jload(path, stride)
        assert str(ours.value) == str(theirs.value)


def test_infer_tube_equals_the_predictor(setup, frame_dir, tmp_path):
    """cli.infer on a frame directory with --stride 2 and --draw: its tube is
    GroundingPredictor.predict's answer for the same frames and frame ids
    (boxes rounded to 2 decimals, as the JAX CLI writes them); one JPEG per
    in-span frame."""
    root, opts, cfg = setup
    run = str(root / "run")
    out = str(tmp_path / "tube.json")
    tube = pinfer.main(["--frames", frame_dir, "--query", "a white box moves", "--stride", "2",
                        "--weights", run, "--out", out, "--draw", str(tmp_path / "draw"),
                        "--device", "cpu"] + opts)
    frames, fids = pinfer.load_frames(frame_dir, 2)
    want = GroundingPredictor(cfg, weights=run, device="cpu").predict(
        frames, "a white box moves", frame_ids=fids)
    assert tube["span"] == list(want["span"]) and tube["frame_ids"] == fids == [0, 2, 4, 6, 8]
    assert tube["boxes"] == {int(f): [round(float(v), 2) for v in b]
                             for f, b in sorted(want["boxes"].items())}
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(tube))
    s, e = tube["span"]
    assert sorted(os.listdir(tmp_path / "draw")) == [f"tube_{f:05d}.jpg" for f in fids
                                                     if s <= f < e]


def _post(port, body, path="/predict"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _npz(frames, text, frame_ids=None):
    buf = io.BytesIO()
    extra = {} if frame_ids is None else {"frame_ids": np.asarray(frame_ids)}
    np.savez(buf, frames=frames, text=np.array(text), **extra)
    return buf.getvalue()


def test_serve_answers_over_http(setup):
    """build_server on port 0: /healthz; a round trip equal to the
    predictor's answer; custom frame ids; four concurrent posts; a body that
    does not parse and frames the predictor refuses give 400; unknown paths
    404."""
    import threading

    root, opts, cfg = setup
    run_cfg = load_config("", opts + ["MODEL.WEIGHT", str(root / "run")])
    server, batcher = pserve.build_server(run_cfg, "127.0.0.1", 0, max_batch=2,
                                          max_wait_ms=20.0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and health["status"] == "ok" and health["max_batch"] == 2
        pred = GroundingPredictor(run_cfg, max_batch=2, device="cpu")

        def expect(frames, text, fids=None):
            r = pred.predict(frames, text, frame_ids=fids)
            return {"boxes": {str(f): [float(v) for v in b] for f, b in r["boxes"].items()},
                    "span": [int(r["span"][0]), int(r["span"][1])]}

        clip = _clip()
        assert _post(port, _npz(clip, "a person waves")) == (200, expect(clip, "a person waves"))
        fids = [3, 5, 7, 9, 11, 13, 15, 17, 19, 21]
        assert _post(port, _npz(clip, "a dog", fids)) == (200, expect(clip, "a dog", fids))
        # concurrent requests share micro-batches: the same answers, to
        # rounding (lane-mates change the batch the arithmetic runs in)
        reqs = [(_clip(t=6 + i, seed=10 + i), f"request {i}") for i in range(4)]
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            got = list(pool.map(lambda r: _post(port, _npz(*r)), reqs))
        for (code, body), r in zip(got, reqs):
            want = expect(*r)
            assert code == 200 and body["span"] == want["span"]
            assert body["boxes"].keys() == want["boxes"].keys()
            for f, box in want["boxes"].items():
                np.testing.assert_allclose(body["boxes"][f], box, atol=1e-3, rtol=0)
        code, body = _post(port, b"not an npz")
        assert code == 400 and "bad request body" in body["error"]
        code, body = _post(port, _npz(np.zeros((4, 8, 8), np.uint8), "not 4d"))
        assert code == 400 and "[T,H,W,3]" in body["error"]
        assert _post(port, _npz(clip, "x"), path="/nope")[0] == 404
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/nope")
        assert conn.getresponse().status == 404
        conn.close()
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_repro_report_and_gate(setup, monkeypatch, capsys):
    """cli.repro --synthetic on a run's directory: the report holds cli.test's
    metrics in points; without a model-zoo target (64 px) a note and no
    deltas; with one (patched in) the deltas, and --require-within exits 1
    only below the gate."""
    root, opts, cfg = setup
    data = str(root / "data")
    base = ["--weights", str(root / "run"), "--data-dir", data, "--synthetic", "--device", "cpu",
            "OUTPUT_DIR", str(root / "out")] + TINY_OPTS
    res = _eval_with(load_config("", opts + ["MODEL.WEIGHT", str(root / "run")]),
                     str(root / "run"))
    report = prepro.main(base)
    assert report["metrics"] == {k: round(100.0 * v, 2) for k, v in res.items()}
    assert report["targets"] == {} and report["deltas"] == {} and "no model-zoo" in report["note"]
    out = capsys.readouterr().out
    assert json.loads(out[out.index('{\n  "dataset"'):]) == report

    target = {"declar_viou": round(100.0 * res["declar_viou"], 2) + 5.0, "inter_viou": 0.0}
    monkeypatch.setitem(prepro.MODEL_ZOO, ("VidSTG", 64), target)
    report = prepro.main(base[:4] + ["--require-within", "5.5"] + base[4:])
    assert report["deltas"]["declar_viou"] == pytest.approx(-5.0, abs=0.02)
    assert report["deltas"]["inter_viou"] == round(100.0 * res["inter_viou"], 2)
    with pytest.raises(SystemExit) as exit_:
        prepro.main(base[:4] + ["--require-within", "4.5"] + base[4:])
    assert exit_.value.code == 1
