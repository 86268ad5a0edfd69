"""K3's share of its roofline in the traced part of the serving window: the
least time of the K3 launches the traced forwards made
(``k3_roofline.k3_forward_bound`` of the configuration's body, at the mix's
forward shape: ``max_batch`` lanes, two streams of the request's frame
bucket, the canvas ``reference/infer.py::model_inputs`` builds for the
mix's frames), over the device time of K3's kernel entries there, in %.
The forwards are the entries' count over K3's launches per forward, which
the port's counters give in this process (``k3.launches`` over
``serve.forwards``). None when any of these is missing: a port without
``serve.forwards``, a trace without K3's entries, a mix of several lengths."""

from portbench.k3_roofline import K3_ENTRIES, k3_forward_bound
from portbench.reference.infer import eval_size, round_up
from portbench.reference.model import arch_of


def read(r):
    if getattr(r, "kind", None) != "serve" or r.trace is None:
        return None
    seconds, entries = r.trace.seconds_of(K3_ENTRIES), r.trace.count_of(K3_ENTRIES)
    if seconds <= 0 or entries == 0 or not isinstance(r.traffic["request_frames"], (int, float)):
        return None
    from stcat_tpu_torch.core import trace

    counters = trace.drain(keep=True)["counters"]
    launches, forwards = counters.get("k3.launches", 0), counters.get("serve.forwards", 0)
    if launches <= 0 or forwards <= 0:
        return None
    cfg, t = r.conf["config"], r.traffic
    arch = arch_of(cfg)
    frames = int(t["request_frames"])
    bucket = min((b for b in cfg["TPU"]["FRAME_BUCKETS"] if b >= (frames + 1) // 2), default=None)
    if bucket is None:
        return None
    oh, ow = eval_size(t["height"], t["width"], cfg["INPUT"]["RESOLUTION"])
    bound, _ = k3_forward_bound(arch["DEPTHS"], arch["DILATION"], t["max_batch"] * 2 * bucket,
                                (round_up(oh, 32), round_up(ow, 32)))
    return 100.0 * bound * entries * forwards / launches / seconds
