"""K1's share of its roofline in the traced part of the evaluation window:
the least time of the K1 calls the traced forwards made (each forward's
four call sites from its batch shape, ``roofline.k1_forward_bound``), over
the device time of K1's kernel entries there, in %. The forwards are the
entries' count over the 24 a forward launches."""

from portbench.roofline import K1_ENTRIES, k1_forward_bound


def read(r):
    if getattr(r, "kind", None) != "eval" or r.trace is None or not r.shapes:
        return None
    seconds = r.trace.seconds_of(K1_ENTRIES)
    launches = r.trace.count_of(K1_ENTRIES)
    if seconds <= 0 or launches == 0:
        return None
    a = r.arch
    b, t, h, w = r.shapes[0]
    bound, per_forward = k1_forward_bound(2 * b, t // 2 + t % 2, a["HEADS"], a["HIDDEN"],
                                          -(-h // 32) * -(-w // 32), r.max_query_len)
    return 100.0 * bound * launches / per_forward / seconds
