"""The port's STCATNet against the JAX package's, end to end on the CPU.

JAX initialises the tiny model; its variables go through
``from_jax_variables`` into the port; both run the same batch (padded frames,
padded pixels, padded tokens) in fp32. Every output, aux layers included, is
held at atol 2e-4 / rtol 1e-3 -- the tolerance tests/test_full_parity.py uses
between the JAX model and torch.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from stcat_tpu.core.batch import VideoBatch as JBatch
from stcat_tpu.models import STCATNet as JNet
from stcat_tpu.train.convert_reference import convert_reference_stcat

from stcat_tpu_torch import config as pconfig
from stcat_tpu_torch.convert import from_jax_variables
from stcat_tpu_torch.core.batch import VideoBatch as PBatch
from stcat_tpu_torch.models import STCATNet as PNet, build_model
from stcat_tpu_torch.models.resnet import BN_EPS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_cfg(jcfg):
    """The JAX config's values in the port's config tree (same keys)."""
    from stcat_tpu.config import to_dict

    return pconfig._merge_dict(pconfig.default_config(), to_dict(jcfg))


def _batch_arrays(b=2, t=6, h=64, w=64, l=7, seed=0):
    rng = np.random.RandomState(seed)
    frame_valid = np.ones((b, t), bool)
    frame_valid[1, 4:] = False
    pixel_valid = np.ones((b, t, h, w), bool)
    pixel_valid[0, :, 40:, :] = False
    pixel_valid[1, :, :, 48:] = False
    token_valid = np.ones((b, l), bool)
    token_valid[1, 5:] = False
    return dict(frames=rng.randn(b, t, h, w, 3).astype(np.float32), frame_valid=frame_valid,
                pixel_valid=pixel_valid,
                token_ids=rng.randint(3, 100, (b, l)).astype(np.int32), token_valid=token_valid)


def _assert_close(ours, theirs, name):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), atol=2e-4, rtol=1e-3,
                               err_msg=name)


@pytest.mark.parametrize("from_scratch", [True, False])
def test_stcatnet_matches_jax(from_scratch):
    jcfg = tiny_cfg(["MODEL.STCAT.FROM_SCRATCH", str(from_scratch).lower(),
                     "TPU.CONV_IMPL", "pallas", "TPU.CONV_STAGES", "[1,2,3,4]"])
    arrays = _batch_arrays()
    jbatch = JBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmodel = JNet(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    ref = jax.jit(jmodel.apply)(variables, jbatch)

    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    consts = jax.tree_util.tree_map(np.asarray, variables["constants"])
    ours = PNet(port_cfg(jcfg)).eval()
    ours.load_state_dict(from_jax_variables(params, consts), strict=True)
    with torch.no_grad():
        out = ours(PBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))

    for key in ("pred_boxes", "pred_sted", "pred_actioness", "weights"):
        _assert_close(out[key], ref[key], key)
    assert len(out["aux_outputs"]) == len(ref["aux_outputs"]) == 1
    for i, (oa, ra) in enumerate(zip(out["aux_outputs"], ref["aux_outputs"])):
        assert set(oa) == set(ra)
        for key in ra:
            _assert_close(oa[key], ra[key], f"aux{i}.{key}")


@pytest.mark.parametrize("extra", [
    [],
    ["MODEL.STCAT.FROM_SCRATCH", "false", "MODEL.VISION_BACKBONE.POS_ENC", "learned",
     "MODEL.STCAT.USE_LEARN_TIME_EMBED", "true"],
])
def test_state_dict_round_trips_through_reference_converter(extra):
    """from_jax_variables(convert_reference_stcat(sd)) == sd: the port's
    names are the reference STCAT layout. FrozenBN is folded by the reference
    converter, so its buffers are drawn in the folded form the inverse
    returns (mean 0, var 1 - eps); the scale survives a float64 fold to
    within one fp32 ulp."""
    jcfg = tiny_cfg(extra)
    model = PNet(port_cfg(jcfg))
    g = torch.Generator().manual_seed(0)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("running_mean"):
            sd[k] = torch.zeros_like(v)
        elif k.endswith("running_var"):
            sd[k] = torch.full_like(v, 1.0 - BN_EPS)
        else:
            sd[k] = torch.randn(v.shape, generator=g)
    params, consts, unused = convert_reference_stcat(sd, jcfg)
    assert unused == set()
    back = from_jax_variables(params, consts)
    assert set(back) == set(sd)
    for k, v in sd.items():
        bn_scale = ".bn" in k or "downsample.1" in k
        if bn_scale and k.endswith(".weight"):
            torch.testing.assert_close(back[k], v, rtol=2e-7, atol=0, msg=k)
        else:
            assert torch.equal(back[k], v), k


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import stcat_tpu_torch\n"
        "for m in pkgutil.walk_packages(stcat_tpu_torch.__path__, 'stcat_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'orbax', 'stcat_tpu', 'PIL', 'tensorboard'))\n"
        "assert not bad, bad\n"
        "for m in ('train.criterion', 'train.optimizer', 'train.step', 'train.loop', "
        "'cli.train', 'cli.test', 'cli.convert', 'cli.infer', 'cli.serve', 'cli.repro', "
        "'cli.precompile', 'models.lstm_text', 'data.loader', 'data.jpeg_decode', "
        "'data.native_decode', 'data.decode', 'data.transforms', 'data.batching', "
        "'data.datasets', 'ops.preprocess', 'core.mesh', 'core.collectives', 'core.dist'):\n"
        "    assert 'stcat_tpu_torch.' + m in sys.modules, m\n"
        "print(len([n for n in sys.modules if n.startswith('stcat_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 62  # every submodule was imported


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    """Every entry point runs on the card unless the CPU is asked for: on a
    host without one each raises, naming CUDA, before it does any work."""
    import importlib

    from stcat_tpu_torch.serve import GroundingPredictor

    cfg = port_cfg(tiny_cfg())
    if torch.cuda.is_available():
        assert next(build_model(cfg).parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        GroundingPredictor(cfg)
    for cli, argv in (("test", []), ("convert", ["--src", "absent.pth", "--out", "absent"]),
                      ("infer", ["--frames", "absent.npy", "--query", "q"]), ("serve", []),
                      ("repro", ["--weights", "absent", "--data-dir", "absent"]),
                      ("precompile", [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            importlib.import_module(f"stcat_tpu_torch.cli.{cli}").main(argv)
    assert next(build_model(cfg, device="cpu").parameters()).device.type == "cpu"
