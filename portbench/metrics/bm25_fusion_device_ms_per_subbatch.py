"""bm25_fusion_device_ms_per_subbatch: device milliseconds under the BM25
arm's and the fusion's spans (overlaps once) per sub-batch of the stretch."""

from portbench.harness.readings import device_under, ratio, traced_subbatches


def read(rec):
    return ratio(device_under(rec, ["bm25_topk_device", "fuse_arms"]), traced_subbatches(rec), 1e3)
