"""Mean host time of ``GroundingPredictor.prepare`` per served batch in the
window (the benchmark's span around it), in ms."""


def read(r):
    if getattr(r, "kind", None) != "serve":
        return None
    d = r.spans.durations("prepare", *r.window)
    return 1e3 * sum(d) / len(d) if d else None
