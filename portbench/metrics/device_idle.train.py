"""Share of the traced part of the training window in which no kernel,
copy or set ran on the device (one minus the union of their intervals), %."""


def read(r):
    if getattr(r, "kind", None) != "train" or r.trace is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
