"""dense_roofline_pct: the dense arm's least time on the card (its bytes
and int8 operations from the shapes, ``portbench/roofline.py``) over the
device time of the operations launched under its span, per sub-batch."""

from portbench.harness.readings import device_under, ratio, traced_subbatches
from portbench.roofline import arm_candidates, dense_arm_work


def read(rec):
    cfg, traffic = rec["cell"]["config"], rec["cell"]["traffic"]
    batch = traffic.get("batch") or cfg["device_batch"]
    k = traffic["k"]
    work = dense_arm_work(
        cfg["n_docs"], cfg["dim"], batch, arm_candidates(k, traffic.get("candidates_per_arm")), k,
        store_bytes=2 if cfg["store"] == "bf16" else 4,
    )
    n = traced_subbatches(rec)
    return ratio(work.seconds * n if n else None, device_under(rec, ["dense_arm_topk"]), 100.0)
