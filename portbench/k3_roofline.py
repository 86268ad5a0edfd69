"""K3's least time from its shapes: the fused stride-1 bottleneck
(``bottleneck_tc`` in bf16, ``bottleneck_fwd`` in fp32) as a served forward
launches it, the K3 counterpart of ``roofline.py``.

The port's smoke test (``chip_smoke.py``: K3_CASES, check_k3) takes its
shapes and arithmetic from here: per launch over N frames of H x W, the
useful multiply-adds of conv1, the 3x3, conv3 and the projection (Cin P +
9 P^2 + P Cout + Cin Cout), two operations each, against the bf16 peak; each
input, weight and output byte once (x and the output in the compute dtype,
the weights too, the fp32 biases) against HBM; the larger of the two. The
dilation changes neither count: a dilated 3x3 does the same useful work.

The blocks come from the configuration's ``DEPTHS`` and ``DILATION``, as
torchvision builds them: every block after a stage's first is stride 1, and
so is layer1.0 (a projection), and with DC5 layer4.0 (a projection at
dilation 1) and the later layer4 blocks at dilation 2.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

from .roofline import PEAK_BF16_FLOPS, PEAK_BYTES

K3_ENTRIES = ("bottleneck_tc", "bottleneck_fwd")
PLANES = (64, 128, 256, 512)


class Block(NamedTuple):
    """One K3 launch: a stride-1 bottleneck block at its feature size."""
    name: str
    h: int
    w: int
    cin: int
    p: int
    cout: int
    dilation: int
    proj: bool


def k3_blocks(depths: Sequence[int], dc5: bool, canvas: Tuple[int, int]) -> List[Block]:
    """The stride-1 blocks of a body on an [H, W] canvas, in order: what one
    forward launches K3 for. Stage i's map is the canvas over its stride (4,
    8, 16, 32, or 16 for DC5's layer4), rounded up, as each halving rounds up."""
    cin, out = 64, []
    for i, (depth, p) in enumerate(zip(depths, PLANES)):
        dilated = dc5 and i == 3
        stride = 2 ** (i + 1 if dilated else i + 2)
        h, w = (-(-n // stride) for n in canvas)
        for j in range(depth):
            if j > 0 or i == 0 or dilated:
                out.append(Block(f"layer{i + 1}.{j}", h, w, cin, p, 4 * p,
                                 2 if dilated and j > 0 else 1, j == 0))
            cin = 4 * p
    return out


def k3_call_work(n: int, b: Block, itemsize: int = 2) -> Tuple[float, int]:
    """(useful operations, least bytes) of one launch over ``n`` frames."""
    macs = b.cin * b.p + 9 * b.p * b.p + b.p * b.cout + (b.cin * b.cout if b.proj else 0)
    nbytes = (itemsize * (n * b.h * b.w * (b.cin + b.cout) + macs)
              + 4 * (2 * b.p + b.cout * (2 if b.proj else 1)))
    return 2.0 * n * b.h * b.w * macs, nbytes


def k3_call_bound(n: int, b: Block, itemsize: int = 2) -> float:
    """Least seconds of one launch over ``n`` frames in bf16."""
    flops, nbytes = k3_call_work(n, b, itemsize)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def k3_forward_bound(depths: Sequence[int], dc5: bool, rows: int, canvas: Tuple[int, int]
                     ) -> Tuple[float, int]:
    """(least seconds, launches) of K3 in one forward of ``rows`` frames."""
    blocks = k3_blocks(depths, dc5, canvas)
    return sum(k3_call_bound(rows, b) for b in blocks), len(blocks)
