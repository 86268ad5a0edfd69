"""The training step's share of the card's bf16 peak: the operations of the
steps taken after the traced part of the window (forward and backward of
each step's batch shape, the recipe's frozen layers left out, counted on
the meta device), over that part's seconds and 989 TFLOP/s, in %."""

from portbench.roofline import PEAK_BF16_FLOPS


def read(r):
    if getattr(r, "kind", None) != "train" or not r.marks.traced_until:
        return None
    done, t_mark = r.marks.traced_until
    shapes = r.shapes[done:]
    seconds = r.window[1] - t_mark
    if not shapes or seconds <= 0.25:
        return None
    cache = {}
    for s in shapes:
        if s not in cache:
            cache[s] = r.flops_of(s)
    return 100.0 * sum(cache[s] for s in shapes) / seconds / PEAK_BF16_FLOPS
