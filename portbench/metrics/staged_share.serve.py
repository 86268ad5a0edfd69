"""Share of the requests that ``MicroBatcher.submit`` staged whose staging
was done when their group's ``prepare`` began, in %: 100 x
``serve.staged_ready`` / (``serve.staged_ready`` + ``serve.staged_waited``),
the port's counters read in the measuring process. The counters count from
the process's start, so the set-up's warm-up requests are in the share
beside the window's. None when no request went through ``submit`` (or the
port has no such counters)."""


def read(r):
    if getattr(r, "kind", None) != "serve":
        return None
    from stcat_tpu_torch.core import trace

    counters = trace.drain(keep=True)["counters"]
    ready, waited = counters.get("serve.staged_ready", 0), counters.get("serve.staged_waited", 0)
    if ready + waited <= 0:
        return None
    return 100.0 * ready / (ready + waited)
