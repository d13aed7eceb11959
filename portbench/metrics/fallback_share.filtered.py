"""fallback_share.filtered: the share of the traced window's host time
spent inside ``HybridRetriever._filtered_fallback``."""

from portbench.harness.readings import ratio, span_sum


def read(rec):
    win = rec["window"]
    return ratio(span_sum(rec, ["filtered_fallback"], "host_s"), win.t1 - win.t0, 100.0)
