"""Mean time from a request's due time to the start of the
``predict_batch`` that serves it (the benchmark's wrapper around the
predictor instance), over the window's requests, in ms."""


def read(r):
    if getattr(r, "kind", None) != "serve" or not r.queue_ms:
        return None
    return sum(r.queue_ms) / len(r.queue_ms)
