"""prepare_us_per_query: host microseconds inside ``HybridRetriever.prepare``
(the C++ planner, the quantiser, the staging) per query it planned."""

from portbench.harness.readings import ratio, span_sum


def read(rec):
    return ratio(span_sum(rec, ["prepare"], "host_s"), span_sum(rec, ["prepare"], "n"), 1e6)
