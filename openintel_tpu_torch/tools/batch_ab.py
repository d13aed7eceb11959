"""The int8 per-super candidate pass against the query sub-batch width
(256, 512, 1,024) at bench scale.

The port's counterpart of the reference's ``scripts/bench_batch_ab.py``:
kernel C2 (``dense_topk_fast_i8``, slots 2, c = 32) over the row-major int8
corpus, candidates only and then the full dense arm (``exact_rescore`` of
the candidates over the f32 rows to k = 10), at each sub-batch width. The
reference's premise: a wider sub-batch spreads one corpus stream over more
queries, so a stream-bound pass costs less a query. The reference also
swept the candidate block width (4,096 / 8,192 / 16,384); the port
validates ``block_c`` and otherwise ignores it (kernel C2's cells do not
depend on it), so those widths select the same program here and are not
timed twice.

    python -m openintel_tpu_torch.tools.batch_ab [N_DOCS] [TOTAL_Q] [--device cpu] [--out PATH]

Defaults 1,250,000 docs and 8,192 queries; env AB_REPS (default 5). The
clock is a pair of CUDA events around each rep of TOTAL_Q / width
sub-batches (the host clock on the CPU).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.tools import common

BATCHES = (256, 512, 1024)
BLOCK_WIDTHS = (4096, 8192, 16384)  # the reference's block_c sweep


def batch_ab(corpus, rows, q8_flat, qf_flat, n_docs: int, *, batches=BATCHES, reps: int) -> list[dict]:
    """Time kernel C2's pass (c = 32), candidates only and with the rescore
    to k = 10, at each sub-batch width of ``batches`` over all the queries
    of ``q8_flat`` (int8) and ``qf_flat`` (f32), (TOTAL_Q, D); one row per
    (width, stage)."""
    total, dim = q8_flat.shape
    out = []
    for full in (False, True):
        for batch in batches:
            nb = total // batch
            q8s = q8_flat[: nb * batch].view(nb, batch, dim)
            qfs = qf_flat[: nb * batch].view(nb, batch, dim)

            def run(i, q8s=q8s, qfs=qfs, full=full):
                _, cids = T.dense_topk_fast_i8(
                    corpus, q8s[i], k=common.C, block_c=common.BLOCK_C, n_docs=n_docs,
                )
                return T.exact_rescore(rows, qfs[i], cids, common.K) if full else cids

            med, best = common.time_per_sub_batch(run, nb, reps, corpus.device)
            stage = "dense-arm" if full else "cand-only"
            out.append({
                "label": f"b={batch} {stage} c={common.C}", "stage": stage,
                "ms_median": med, "ms_best": best, "batch": batch, "nb": nb,
            })
    return out


def block_width_note() -> str:
    return (
        f"block_c {'/'.join(map(str, BLOCK_WIDTHS))} (the reference's sweep) select the "
        "same program here: dense_topk_fast_i8 validates block_c and its cells do not "
        "depend on it, so each width is timed once"
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("n_docs", nargs="?", type=int, default=1_250_000)
    parser.add_argument("total_q", nargs="?", type=int, default=8192)
    common.add_device_flags(parser, "batch_ab")
    args = parser.parse_args(argv)
    device = common.tool_device(args.device)
    reps = int(os.environ.get("AB_REPS", "5"))
    stamp = common.stamp(device)
    print(common.device_line(device), flush=True)
    t0 = time.perf_counter()
    emb, q = common.script_corpus(args.n_docs, args.total_q, near_docs=True)
    rows, corpus, q8, qf = common.device_operands(emb, q, 1, args.total_q, device)
    del emb
    print(
        f"corpus {args.n_docs}x{common.DIM} + {args.total_q} queries staged on {device} "
        f"({time.perf_counter() - t0:.1f}s)",
        flush=True,
    )
    print(
        f"timing: {'CUDA events' if device.type == 'cuda' else 'host clock'}, {reps} reps "
        f"of the {args.total_q} queries (TOTAL_Q / width sub-batches) after a warm-up; "
        "median and best per sub-batch (the reference timed a jitted lax.scan)",
        flush=True,
    )
    print(block_width_note(), flush=True)
    out = batch_ab(corpus, rows, q8[0], qf[0], args.n_docs, batches=BATCHES, reps=reps)
    for row in out:
        print(common.row_line(row), flush=True)
    res = {
        "metric": "c2_ms_per_sub_batch_by_width", **stamp, "n_docs": args.n_docs,
        "total_q": args.total_q, "reps": reps, "block_widths": block_width_note(), "rows": out,
    }
    print(f"wrote {common.write_json(res, args.out, 'batch_ab')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
