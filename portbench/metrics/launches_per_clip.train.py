"""Device kernels the profiler saw in the traced part of the training
window, per clip stepped there (copies and sets not counted)."""


def read(r):
    if getattr(r, "kind", None) != "train" or r.trace is None or not r.marks.traced_until:
        return None
    clips = sum(s[0] for s in r.shapes[: r.marks.traced_until[0]])
    if clips == 0 or r.trace.kernels == 0:
        return None
    return r.trace.kernels / clips
