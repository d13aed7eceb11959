"""Decomposition of the int8 per-super candidate pass on the card.

The port's counterpart of the reference's ``scripts/bench_kernel_decomp.py``.
Probes, all over the same row-major int8 corpus and the same 32-query
tiles:

- dot-only: kernel S (``csrc/dot_only_tma.cu``), the products summed per
  lane, with no key pack or fold: the stream and tensor-core floor, its
  blocks unpaired as C2's are (S is served in 2-block clusters);
- fold-only: kernel C2 (``csrc/turbo_i8_tma.cu``), the key pack and top-2
  fold, its cells written out and not reduced;
- slots=1 / slots=2: ``dense_topk_fast_i8`` at k=32, kernel C1 or C2 plus
  the candidate selection and decode, the whole candidate pass;

and one derived row, fold = fold-only - dot-only (medians, and bests).

Each row's label names the stream its kernel runs on. S, C1 and C2 all run
on the TMA + wgmma stream of ``csrc/tma_stream.cuh`` with kernel A's
geometry, S and C2 both unpaired here, so the derived row subtracts like
from like: what C2's key pack, fold and cell writes cost over the products
summed in place (S adds its sums into the output once a block, C2 writes
its cells; the rest of their streams is one code path). The same-stream split of C2 into its
stream, products and fold with parts compiled out is
``tools/stream_ablation.py``'s.

The port's selection is an exact top-k (ties to the lower column) where the
reference ran ``approx_max_k``; the rows say "+select".

    python -m openintel_tpu_torch.tools.kernel_decomp [N_DOCS] [BATCH] [NB]

Env: AB_REPS (default 5). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.tools import common

# the stream the probes' kernels run on
TMA_STREAM = "[TMA+wgmma stream]"


def decompose(
    corpus: torch.Tensor,  # (N_pad, D) int8, padded to the 16,384-doc unit
    q8s: torch.Tensor,  # (NB, BATCH, D) int8 queries, on the corpus's device
    n_docs: int,
    *,
    reps: int,
) -> list[dict]:
    """Time the four probes over the NB sub-batches (the candidate passes at
    k=32); one row each, then the derived fold row (``derived``: a
    difference of two rows, not a time of its own)."""
    nb, batch, _ = q8s.shape
    q_pad = [T._pad_query_rows(q, T._I8_QUERY_TILE).contiguous() for q in q8s]

    def candidates(slots):
        return lambda i: T.dense_topk_fast_i8(
            corpus, q8s[i], k=common.C, block_c=common.BLOCK_C, n_docs=n_docs,
            slots=slots,
        )

    probes = [
        (
            f"dot-only (MXU+stream floor) {TMA_STREAM}",
            lambda i: T.dot_only_cells(q_pad[i], corpus, paired=False),  # as C2 runs
        ),
        (
            f"fold-only (pack+2max, no topk) {TMA_STREAM}",
            lambda i: T.i8_turbo_cells(q_pad[i], corpus, slots=2),
        ),
        (f"turbo slots=1 (+select+dec) {TMA_STREAM}", candidates(1)),
        (f"turbo slots=2 (+select+dec) {TMA_STREAM}", candidates(2)),
    ]
    rows = []
    for label, run in probes:
        med, best = common.time_per_sub_batch(run, nb, reps, corpus.device)
        rows.append({"label": label, "ms_median": med, "ms_best": best, "batch": batch})
    dot, fold = rows[0], rows[1]
    rows.append({
        "label": f"fold = fold-only - dot-only {TMA_STREAM}",
        "ms_median": fold["ms_median"] - dot["ms_median"],
        "ms_best": fold["ms_best"] - dot["ms_best"],
        "batch": batch,
        "derived": True,
    })
    return rows


def main(argv=None) -> int:
    args = common.parse_args(argv, __doc__)
    reps = int(os.environ.get("AB_REPS", "5"))
    device = torch.device(args.device)
    print(common.device_line(device), flush=True)
    t0 = time.perf_counter()
    emb, q = common.script_corpus(args.n_docs, args.nb * args.batch, near_docs=False)
    _, corpus, q8s, _ = common.device_operands(emb, q, args.nb, args.batch, device)
    del emb
    print(
        f"corpus {args.n_docs}->{corpus.shape[0]} rows, {args.nb}x{args.batch} "
        f"queries on {device} ({time.perf_counter() - t0:.1f}s)",
        flush=True,
    )
    print(common.clock_note(device, reps, args.nb), flush=True)
    for row in decompose(corpus, q8s, args.n_docs, reps=reps):
        print(common.row_line(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
