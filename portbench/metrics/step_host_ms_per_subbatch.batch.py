"""step_host_ms_per_subbatch.batch: host milliseconds inside the step's
spans (``run_prepared_device`` and ``finalize_prepared``, or the dense
search call) per sub-batch."""

from portbench.harness.readings import ratio, span_sum, subbatches

STEP = ("run_prepared_device", "finalize_prepared", "search_embeddings")


def read(rec):
    return ratio(span_sum(rec, STEP, "host_s"), subbatches(rec), 1e3)
