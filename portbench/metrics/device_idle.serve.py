"""Share of the traced part of the serving window in which no kernel, copy
or set ran on the device, in %."""


def read(r):
    if getattr(r, "kind", None) != "serve" or r.trace is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
