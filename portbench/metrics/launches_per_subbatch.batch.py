"""launches_per_subbatch.batch: kernels the profiler saw in the traced
stretch per sub-batch the stretch ran."""

from portbench.harness.readings import ratio, traced_subbatches


def read(rec):
    t = rec.get("trace")
    return ratio(t["kernels"] if t and t["kernels"] else None, traced_subbatches(rec))
