"""The yardstick: the card's published peaks, the model's operations per
clip counted on the meta device, and K1's least time from its shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s in bf16 on the
tensor cores, 3.35 TB/s of HBM3. K1's arithmetic is the port's smoke
test's (``chip_smoke.py``: K1_CASES, check_k1), frozen here: per call
2 BH Sq Sk (Dk + Dv) operations and each input and output byte once, the
fp32 key bias included.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

K1_ENTRIES = ("flash_fwd_mma", "flash_fwd_tiled", "flash_fwd_rows")


def k1_cases(lanes: int, frames: int, heads: int, d: int, hw: int, l: int
             ) -> List[Tuple[str, int, int, int, int, int, int]]:
    """(name, BH, Sq, Sk, Dk, Dv, launches) of K1's call sites in one
    forward of ``lanes`` clips of ``frames`` frames: six encoder and six of
    each decoder's layers."""
    hd = d // heads
    s, m = 1 + hw + l, hw + l
    return [
        ("encoder spatial", lanes * frames * heads, s, s, hd, hd, 6),
        ("encoder temporal", lanes * heads, frames + 1, frames + 1, hd, hd, 6),
        ("spatial-decoder concat cross", lanes * frames * heads, 1, m, 2 * hd, hd, 6),
        ("time-decoder cross", lanes * frames * heads, 1, m, hd, hd, 6),
    ]


def k1_call_bound(bh: int, sq: int, sk: int, dk: int, dv: int, itemsize: int = 2) -> float:
    """Least seconds of one K1 call: operations against the bf16 peak or
    bytes against HBM, whichever is larger."""
    flops = 2.0 * bh * sq * sk * (dk + dv)
    nbytes = itemsize * (bh * sq * dk + bh * sk * dk + bh * sk * dv + bh * sq * dv) + 4 * bh * sk
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def k1_forward_bound(lanes: int, frames: int, heads: int, d: int, hw: int, l: int) -> Tuple[float, int]:
    """(least seconds, launches) of K1 in one forward."""
    cases = k1_cases(lanes, frames, heads, d, hw, l)
    return (sum(n * k1_call_bound(bh, sq, sk, dk, dv) for _, bh, sq, sk, dk, dv, n in cases),
            sum(c[-1] for c in cases))


def count_flops(arch: Dict, batch: int, frames: int, canvas: Tuple[int, int], l: int,
                train: bool, solver: Dict = None) -> float:
    """Operations of one forward (and, with ``train``, the backward the
    recipe's freezing leaves, with no recompute) of the reference model on
    the meta device, by ``torch.utils.flop_counter.FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.model import STCAT
    from .reference.train import group_of, total_loss

    with torch.device("meta"):
        model = STCAT(arch)
        h, w = canvas
        frames_t = torch.zeros(batch, frames, h, w, 3)
        fv = torch.ones(batch, frames, dtype=torch.bool)
        pv = torch.ones(batch, frames, h, w, dtype=torch.bool)
        ids = torch.zeros(batch, l, dtype=torch.long)
        tv = torch.ones(batch, l, dtype=torch.bool)
        counter = FlopCounterMode(display=False)
        with counter:
            if train:
                model.train()
                for n, p in model.named_parameters():
                    p.requires_grad_(group_of(n) != "frozen")
                model_out = _forward_without_dropout(model, frames_t, fv, pv, ids, tv)
                tg = {"boxes": torch.zeros(batch, frames, 4), "box_valid": fv,
                      "actioness": torch.zeros(batch, frames),
                      "temp_bound": torch.zeros(batch, 2, dtype=torch.long)}
                total_loss(model_out, tg, fv, solver, arch["DEC_LAYERS"]).backward()
            else:
                with torch.no_grad():
                    model.eval()(frames_t, fv, pv, ids, tv)
    return float(counter.get_total_flops())


def _forward_without_dropout(model, *args):
    """A training forward with dropout's rate set to 0 (its masks are not
    products; the meta device has no generator to draw them)."""
    saved = {}
    for mod in model.modules():
        if hasattr(mod, "p") and isinstance(mod.p, float):
            saved[mod] = mod.p
            mod.p = 0.0
    try:
        return model(*args)
    finally:
        for mod, p in saved.items():
            mod.p = p
