"""Card-only tests of the port: the CUDA kernels against their plain versions,
and the tiny model's kernel forward on the card against its plain forward on
the CPU. Every test here is marked ``cuda`` and skips without a card.

This file imports torch and numpy only, so it also runs where JAX is not
installed (the machine with the card):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerances are relative to max |plain|: fp32 differs in summation order only
(1e-4); bf16 also rounds p (attention) and x1/y2 (bottleneck) at other points
than the plain version (2e-2, about two bf16 ulps).
"""

import numpy as np
import pytest
import torch

from stcat_tpu_torch.kernels import attention as pka
from stcat_tpu_torch.kernels import bottleneck as pkb

TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    return err / max(1.0, ref.float().abs().max().item())


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("bh,sq,sk,dk,dv", [
    (4, 37, 53, 32, 32), (8, 1, 223, 32, 32), (2, 130, 300, 32, 32), (8, 1, 53, 64, 32),
    (8, 8, 896, 32, 32), (3, 5, 40, 100, 70), (64, 293, 293, 32, 32),
])
def test_flash_attention_kernel_matches_plain(dev, dtype, tol, bh, sq, sk, dk, dv):
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev, dtype)
               for s in ((bh, sq, dk), (bh, sk, dk), (bh, sk, dv)))
    bias = torch.zeros(bh, sk, device=dev)
    bias[:, sk - 7:] = -1e30
    bias[1, :] = -1e30  # fully masked row: uniform average over the real keys
    before = pka.LAUNCHES.count
    out = pka.flash_attention(q, k, v, bias)
    assert pka.LAUNCHES.count == before + 1
    ref = pka.attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert out.shape == (bh, sq, dv) and out.dtype == dtype
    assert _rel_err(out, ref) <= tol


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("n,h,w,cin,p,ds,dil", [
    (2, 8, 8, 16, 8, True, 1),
    (1, 8, 6, 32, 8, False, 1),
    (1, 10, 10, 32, 8, False, 2),
    (1, 10, 152, 64, 64, True, 1),    # several tiles, the last one partial
    (1, 9, 152, 256, 64, False, 2),   # dilated, several tiles
])
def test_fused_bottleneck_kernel_matches_plain(dev, dtype, tol, n, h, w, cin, p, ds, dil):
    rng = np.random.RandomState(1)
    cout = 4 * p

    def mk(*s, scale):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32)).to(dev)

    bw = pkb.BlockWeights(
        w1=mk(cin, p, scale=cin ** -0.5), b1=mk(1, 1, p, scale=0.1),
        w2=mk(3, 3, p, p, scale=(9 * p) ** -0.5), b2=mk(1, 1, p, scale=0.1),
        w3=mk(p, cout, scale=p ** -0.5), b3=mk(1, 1, cout, scale=0.1),
        wd=mk(cin, cout, scale=cin ** -0.5) if ds else None,
        bd=mk(1, 1, cout, scale=0.1) if ds else None,
    )
    x = mk(n, h, w, cin, scale=1.0).to(dtype)
    before = pkb.LAUNCHES.count
    out = pkb.fused_bottleneck(x, bw, dil)
    assert pkb.LAUNCHES.count == before + 1
    ref = pkb.bottleneck_plain(x, bw, dil)
    torch.cuda.synchronize()
    assert out.shape == (n, h, w, cout) and out.dtype == dtype
    assert _rel_err(out, ref) <= tol


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(2, 3, 16, device=dev)
    bias = torch.zeros(2, 5, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        pka.flash_attention(q, torch.zeros(2, 16, 5, device=dev).transpose(1, 2),
                            torch.zeros(2, 5, 8, device=dev), bias)
    with pytest.raises(ValueError, match="head dims"):
        pka.flash_attention(torch.zeros(2, 3, 160, device=dev), torch.zeros(2, 5, 160, device=dev),
                            torch.zeros(2, 5, 8, device=dev), bias)
    with pytest.raises(ValueError, match="CUDA"):
        pka.flash_attention(q, torch.zeros(2, 5, 16), torch.zeros(2, 5, 8), bias.cpu())
    x = torch.zeros(1, 4, 4, 8, device=dev)
    z = lambda *s: torch.zeros(*s, device=dev)
    bw = pkb.BlockWeights(z(8, 4), z(1, 1, 4), z(3, 3, 4, 4), z(1, 1, 4), z(4, 16), z(1, 1, 16),
                          None, None)
    with pytest.raises(ValueError, match="Cin == Cout"):
        pkb.fused_bottleneck(x, bw, 1)


def test_tiny_model_kernel_forward_matches_cpu_plain_forward(dev):
    """The whole port at tiny widths: STCATNet with every kernel route on,
    kernels on the card against the plain versions on the CPU, fp32."""
    from stcat_tpu_torch.config import default_config, merge_from_list
    from stcat_tpu_torch.core.batch import VideoBatch
    from stcat_tpu_torch.models import build_model

    cfg = merge_from_list(default_config(), [
        "MODEL.VISION_BACKBONE.NAME", "resnet50", "MODEL.VISION_BACKBONE.DEPTHS", "[1,1,1,1]",
        "MODEL.STCAT.ENC_LAYERS", 2, "MODEL.STCAT.DEC_LAYERS", 2, "MODEL.STCAT.HIDDEN", 64,
        "MODEL.STCAT.HEADS", 4, "MODEL.STCAT.FFN_DIM", 128, "INPUT.MAX_VIDEO_LEN", 32,
        "MODEL.TEXT_MODEL.VOCAB_SIZE", 128, "MODEL.TEXT_MODEL.HIDDEN", 32,
        "MODEL.TEXT_MODEL.LAYERS", 2, "MODEL.TEXT_MODEL.HEADS", 2,
        "MODEL.TEXT_MODEL.INTERMEDIATE", 64, "MODEL.TEXT_MODEL.MAX_POS", 64,
        "TPU.COMPUTE_DTYPE", "float32", "TPU.CONV_IMPL", "pallas", "TPU.CONV_STAGES", "[1,2,3,4]",
    ])
    rng = np.random.RandomState(2)
    b, t, h, w, l = 2, 6, 64, 64, 7
    frame_valid = np.ones((b, t), bool)
    frame_valid[1, 4:] = False
    pixel_valid = np.ones((b, t, h, w), bool)
    pixel_valid[0, :, 40:] = False
    token_valid = np.ones((b, l), bool)
    token_valid[1, 5:] = False
    arrays = dict(frames=rng.randn(b, t, h, w, 3).astype(np.float32), frame_valid=frame_valid,
                  pixel_valid=pixel_valid, token_ids=rng.randint(3, 100, (b, l)),
                  token_valid=token_valid)
    outs = {}
    for device in ("cpu", "cuda"):
        model = build_model(cfg, device=device, seed=0)
        batch = VideoBatch(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})
        a0, b0 = pka.LAUNCHES.count, pkb.LAUNCHES.count
        with torch.inference_mode():
            outs[device] = model(batch)
        launched = (pka.LAUNCHES.count - a0, pkb.LAUNCHES.count - b0)
        # attention: 2 spatial + 2 temporal encoder layers, 2 + 2 decoder cross
        # attentions; bottleneck: layer1's block (the others are stride-2 firsts)
        assert launched == ((0, 0) if device == "cpu" else (8, 1))
    for key in ("pred_boxes", "pred_sted", "pred_actioness", "weights"):
        np.testing.assert_allclose(outs["cuda"][key].cpu().numpy(), outs["cpu"][key].numpy(),
                                   atol=2e-4, rtol=1e-3, err_msg=key)
