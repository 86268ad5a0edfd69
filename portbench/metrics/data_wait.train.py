"""Share of the training window the loop waited on ``next()`` of the
prefetch stream (the benchmark's "next_batch" spans), in %."""


def read(r):
    if getattr(r, "kind", None) != "train":
        return None
    lo, hi = r.window
    return 100.0 * r.spans.total("next_batch", lo, hi) / (hi - lo)
