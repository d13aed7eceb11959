"""A/B of the per-super int8 candidate pass against the grouped one.

The port's counterpart of the reference's ``scripts/bench_grouped_ab.py``:
``dense_topk_fast_i8`` (kernel C2, top-2 per lane and super, then the
selection) against ``dense_topk_fast_i8_grouped`` (kernel A, top-2 per lane
and group of g supers, then an exact top-k) at each g of AB_GROUPS, both at
c=32 candidates, then ``exact_rescore`` and recall@10 of the first
AB_SAMPLE queries against the exact float32 oracle. The reference adopted
the grouped kernel as the int8 default on this comparison (>= 15 % faster
at recall within 0.001).

    python -m openintel_tpu_torch.tools.grouped_ab [N_DOCS] [BATCH] [NB]

Env: AB_REPS (default 5), AB_SAMPLE (default 512), AB_GROUPS (default
"4,8,16"). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.tools import common


def grouped_ab(
    corpus: torch.Tensor,  # (N_pad, D) int8, padded to the 16,384-doc unit
    rows: torch.Tensor,  # (N, D) f32 or bf16 rescore rows
    q8s: torch.Tensor,  # (NB, BATCH, D) int8 queries
    qfs: torch.Tensor,  # (NB, BATCH, D) f32 queries
    n_docs: int,
    ref_ids: np.ndarray,  # (sample, k) the oracle's ids of the first queries
    *,
    groups,
    reps: int,
) -> list[dict]:
    """Time the per-super pass and the grouped pass at each group size, each
    of c=32 candidates with the rescore to k=10, over the NB sub-batches
    and measure recall@10; one row per variant (``group`` 0 is the
    per-super pass)."""
    nb, batch, _ = q8s.shape
    rows_out = []
    for group in [0, *groups]:
        outs = [None] * nb

        def run(i, group=group, outs=outs):
            if group == 0:
                _, cids = T.dense_topk_fast_i8(
                    corpus, q8s[i], k=common.C, block_c=common.BLOCK_C, n_docs=n_docs
                )
            else:
                _, cids = T.dense_topk_fast_i8_grouped(
                    corpus, q8s[i], k=common.C, block_c=common.BLOCK_C,
                    n_docs=n_docs, group=group,
                )
            outs[i] = T.exact_rescore(rows, qfs[i], cids, common.K)[1]

        med, best = common.time_per_sub_batch(run, nb, reps, corpus.device)
        ids = torch.cat(outs).cpu().numpy()
        rows_out.append({
            "label": "int8 per-super+select" if group == 0 else f"grouped g={group}",
            "group": group, "ms_median": med, "ms_best": best, "batch": batch,
            "recall": common.recall_at_k(ids, ref_ids),
        })
    return rows_out


def main(argv=None) -> int:
    args = common.parse_args(argv, __doc__)
    reps = int(os.environ.get("AB_REPS", "5"))
    total = args.nb * args.batch
    sample = min(int(os.environ.get("AB_SAMPLE", "512")), total)
    groups = [int(g) for g in os.environ.get("AB_GROUPS", "4,8,16").split(",")]
    device = torch.device(args.device)
    print(common.device_line(device), flush=True)
    t0 = time.perf_counter()
    emb, q = common.script_corpus(args.n_docs, total, near_docs=True)
    rows, corpus, q8s, qfs = common.device_operands(emb, q, args.nb, args.batch, device)
    del emb
    print(f"corpus + queries staged on {device} ({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    ref_ids = common.exact_ids(rows, qfs.view(total, -1)[:sample])
    print(
        f"exact reference over {sample} queries ({time.perf_counter() - t0:.1f}s)",
        flush=True,
    )
    print(common.clock_note(device, reps, args.nb), flush=True)
    for row in grouped_ab(
        corpus, rows, q8s, qfs, args.n_docs, ref_ids, groups=groups, reps=reps
    ):
        print(common.row_line(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
