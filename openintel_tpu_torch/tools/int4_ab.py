"""int8 candidates (c = 32) against nibble-packed int4 candidates (wider c),
each followed by the exact rescore, at bench scale.

The port's counterpart of the reference's ``scripts/bench_int4_ab.py``:
kernel C2 (``dense_topk_fast_i8``, slots 2) at c = 32 against kernel E2
(``dense_topk_fast_i4``, slots 2) at c = 128 and 256 on the served
quantiser scale (32) and at c = 128 on scale 40 (clip at |x| = 0.2). The
int4 corpus streams half the bytes; its coarser quantiser needs a wider
fetch. Each variant's row: ms per sub-batch of the candidates alone and of
the full dense arm (``exact_rescore`` over the f32 rows to k = 10), and
recall@10 of the first AB_SAMPLE queries against the port's NumPy oracle
(``ops/reference.rank_topk`` over the float32 scores, ties to the lower
id). The reference's two ``bc`` variants time other block widths; the port
validates ``block_c`` and otherwise ignores it (kernel E2's cells do not
depend on it), so they select the program of ``int4 c=256`` and are not
timed twice.

    python -m openintel_tpu_torch.tools.int4_ab [N_DOCS] [BATCH] [NB] [--device cpu] [--out PATH]

Defaults 1,250,000 docs, sub-batches of 256, 16 of them. Env: AB_REPS
(default 6), AB_SAMPLE (default 128), AB_VARIANTS (default
"int8,int4c128,int4c256,int4s40,int4bc2048,int4bc8192").
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from openintel_tpu_torch import convert
from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.ops import reference
from openintel_tpu_torch.tools import common

VARIANTS = "int8,int4c128,int4c256,int4s40,int4bc2048,int4bc8192"
# variant -> (label, arm, c, quantiser scale, block_c; None: the batch's)
PLAN = {
    "int8": ("int8 (production)", "int8", 32, None, None),
    "int4c128": ("int4 c=128", "int4", 128, 32.0, 4096),
    "int4c256": ("int4 c=256", "int4", 256, 32.0, 4096),
    "int4s40": ("int4 c=128 s=40", "int4", 128, 40.0, 4096),
    "int4bc2048": ("int4 c=256 bc=2048", "int4", 256, 32.0, 2048),
    "int4bc8192": ("int4 c=256 bc=8192", "int4", 256, 32.0, 8192),
}


def oracle_ids(emb: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The exact top-K ids of each query of ``q`` over the unit rows
    ``emb`` by the port's oracle, (len(q), K)."""
    return reference.rank_topk(q @ emb.T, common.K)[1]


def int4_ab(corpora: dict, rows, q8s, qfs, n_docs: int, ref_ids: np.ndarray, *, variants, reps: int) -> list[dict]:
    """Time each variant of ``variants`` (keys of ``PLAN``): its candidate
    pass alone and the full dense arm over the NB sub-batches, and its
    recall@10 on the first queries. ``corpora`` maps "int8" and each int4
    scale to its corpus. A block-width variant whose program another
    variant already timed gets a row that points at it instead."""
    nb, batch, _ = q8s.shape
    timed: dict = {}
    out = []
    for name in [v for v in PLAN if v in variants]:
        label, arm, c, scale, bc = PLAN[name]
        program = (arm, c, scale)
        if program in timed:
            out.append({"label": label, "variant": name, "same_as": timed[program], "c": c})
            continue
        corpus = corpora["int8" if arm == "int8" else scale]
        bc = bc or (8192 if batch >= 128 else 4096)
        stages = {}
        for full in (False, True):
            ids = [None] * nb

            def run(i, full=full, ids=ids):
                if arm == "int8":
                    _, cids = T.dense_topk_fast_i8(corpus, q8s[i], k=c, block_c=bc, n_docs=n_docs)
                else:
                    _, cids = T.dense_topk_fast_i4(
                        corpus, q8s[i], k=c, block_c=bc, n_docs=n_docs, scale=scale,
                    )
                ids[i] = T.exact_rescore(rows, qfs[i], cids, common.K)[1] if full else cids

            stages[full] = (*common.time_per_sub_batch(run, nb, reps, corpus.device), ids)
        got = torch.cat(stages[True][2]).cpu().numpy()
        timed[program] = label
        out.append({
            "label": label, "variant": name, "c": c, "batch": batch,
            "cand_ms_median": stages[False][0], "cand_ms_best": stages[False][1],
            "ms_median": stages[True][0], "ms_best": stages[True][1],
            "recall": common.recall_at_k(got, ref_ids),
        })
    return out


def row_line(row: dict) -> str:
    if "same_as" in row:
        return (
            f"{row['label']:<22} c={row['c']:<4} the program of {row['same_as']} here "
            "(block_c is validated, not used): not timed twice"
        )
    best = row["ms_best"]
    return (
        f"{row['label']:<22} c={row['c']:<4} cand {row['cand_ms_median']:7.3f} ms/b "
        f"(best {row['cand_ms_best']:7.3f})  dense-arm {row['ms_median']:7.3f} ms/b "
        f"(best {best:7.3f}, {row['batch'] * 1e3 / best:>10,.0f} QPS)  "
        f"recall@{common.K} {row['recall']:.4f}"
    )


def main(argv=None) -> int:
    args = common.parse_args(argv, __doc__, nb=16, out="int4_ab")
    device = common.tool_device(args.device)
    reps = int(os.environ.get("AB_REPS", "6"))
    total = args.nb * args.batch
    sample = min(int(os.environ.get("AB_SAMPLE", "128")), total)
    variants = set(os.environ.get("AB_VARIANTS", VARIANTS).split(","))
    stamp = common.stamp(device)
    print(common.device_line(device), flush=True)
    t0 = time.perf_counter()
    emb, q = common.script_corpus(args.n_docs, total, near_docs=True)
    rows, i8, q8s, qfs = common.device_operands(emb, q, args.nb, args.batch, device)
    corpora = {"int8": i8}
    for scale in sorted({PLAN[v][3] for v in variants if v in PLAN and PLAN[v][1] == "int4"}):
        corpora[scale] = convert.int4_corpus(rows, scale=scale)
    print(
        f"corpus {args.n_docs}x{common.DIM} + {args.nb}x{args.batch} queries on {device}: "
        f"int8 {i8.nbytes / 1e9:.2f} GB, int4 {sum(c.nbytes for s, c in corpora.items() if s != 'int8') / 1e9:.2f} GB, "
        f"f32 rescore {rows.nbytes / 1e9:.2f} GB ({time.perf_counter() - t0:.1f}s)",
        flush=True,
    )
    t0 = time.perf_counter()
    ref_ids = oracle_ids(emb, q[:sample])
    del emb
    print(f"exact reference over {sample} queries ({time.perf_counter() - t0:.1f}s)", flush=True)
    print(common.clock_note(device, reps, args.nb), flush=True)
    out = int4_ab(corpora, rows, q8s, qfs, args.n_docs, ref_ids, variants=variants, reps=reps)
    for row in out:
        print(row_line(row), flush=True)
    res = {
        "metric": "int8_vs_int4_dense_arm", **stamp, "n_docs": args.n_docs, "batch": args.batch,
        "nb": args.nb, "reps": reps, "sample": sample, "rows": out,
    }
    print(f"wrote {common.write_json(res, args.out, 'int4_ab')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
