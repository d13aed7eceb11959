"""A/B of the reductions after the per-super int8 candidate kernel.

The port's counterpart of the reference's ``scripts/bench_topk_reduce_ab.py``.
Every variant consumes kernel C2's top-2 cells (``csrc/turbo_i8.cu``), one
(B, 2 * n_super * 128) buffer, all slot-1 keys then all slot-2 keys:

- approx: the served selection, which the port runs exact (ties to the lower
  column) where the reference ran ``approx_max_k``: the top c + 32 keys,
  decode, then the exact top c of the valid ones;
- group<G>: per (slot, lane), the max and argmax over each group of G
  supers, then an exact top c over the 2 * ceil(n_super / G) * 128 survivors,
  decoded with the argmax's super (top-2 per lane and group of supers: a
  weaker guarantee, so recall is measured per variant);
- exact-topk-<W>: an exact top c over all W = 2 * n_super * 128 columns.

Then ``exact_rescore`` of the c candidates in float32, and recall@10 of the
first AB_SAMPLE queries against the exact float32 oracle.

    python -m openintel_tpu_torch.tools.topk_reduce_ab [N_DOCS] [BATCH] [NB]

Env: AB_REPS (default 5), AB_SAMPLE (default 128). Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.ops.ranking import stable_topk
from openintel_tpu_torch.tools import common


def _decode_columns(keys, cols, n_super):
    """Per-super cell columns -> doc ids; both slot halves decode alike."""
    col = cols % (n_super * 128)
    return ((col // 128) * 128 + (keys & 127)) * 128 + col % 128


def reduce_select(packed: torch.Tensor, n_super: int, n_docs: int, c: int) -> torch.Tensor:
    """The served selection: top c + 32 keys, decode, exact top c of the
    valid ones. Returns (B, c) int32 ids, -1 where invalid."""
    fv, cols = stable_topk(packed.view(torch.float32), min(c + 32, packed.shape[1]))
    keys = fv.view(torch.int32)
    ids = _decode_columns(keys, cols, n_super).to(torch.int32)
    valid = (ids < n_docs) & (keys > 0)
    _, sel = stable_topk(torch.where(valid, keys, T._INT32_MIN), min(c, keys.shape[1]))
    return torch.gather(torch.where(valid, ids, -1), 1, sel)


def reduce_grouped(
    packed: torch.Tensor, n_super: int, n_docs: int, c: int, g: int
) -> torch.Tensor:
    """Max and argmax (the first super among equal keys) over groups of
    ``g`` supers per (slot, lane), then an exact top c of the valid
    survivors. Returns (B, c) int32 ids, -1 where invalid."""
    b = packed.shape[0]
    ng = -(-n_super // g)
    pk = packed.view(b, 2, n_super, 128)
    if ng * g != n_super:  # pad the super axis with sentinel-0 keys
        pk = torch.nn.functional.pad(pk, (0, 0, 0, ng * g - n_super))
    best, arg = pk.view(b, 2, ng, g, 128).max(dim=3)
    width = 2 * ng * 128
    keys = best.reshape(b, width)
    col = torch.arange(width, device=packed.device)
    sup = ((col // 128) % ng) * g + arg.reshape(b, width)
    ids = ((sup * 128 + (keys & 127)) * 128 + col % 128).to(torch.int32)
    valid = (ids < n_docs) & (keys > 0)
    _, sel = stable_topk(torch.where(valid, keys, T._INT32_MIN), min(c, width))
    return torch.gather(torch.where(valid, ids, -1), 1, sel)


def reduce_exact_topk(packed: torch.Tensor, n_super: int, n_docs: int, c: int) -> torch.Tensor:
    """An exact top c over every column, then the decode. Returns (B, c)
    int32 ids, -1 where invalid."""
    keys, cols = stable_topk(packed, min(c, packed.shape[1]))
    ids = _decode_columns(keys, cols, n_super).to(torch.int32)
    return torch.where((ids < n_docs) & (keys > 0), ids, -1)


GROUPS = (4, 8, 16)  # the reference script's group sizes


def reducers(n_super: int) -> dict:
    """Variant name -> reducer(packed, n_docs, c)."""
    out = {"approx (exact select)": lambda p, n, c: reduce_select(p, n_super, n, c)}
    for g in GROUPS:
        out[f"group{g}"] = lambda p, n, c, g=g: reduce_grouped(p, n_super, n, c, g)
    out[f"exact-topk-{2 * n_super * 128}"] = (
        lambda p, n, c: reduce_exact_topk(p, n_super, n, c)
    )
    return out


def reduce_ab(
    corpus: torch.Tensor,  # (N_pad, D) int8, padded to the 16,384-doc unit
    rows: torch.Tensor,  # (N, D) f32 or bf16 rescore rows
    q8s: torch.Tensor,  # (NB, BATCH, D) int8 queries
    qfs: torch.Tensor,  # (NB, BATCH, D) f32 queries
    n_docs: int,
    ref_ids: np.ndarray,  # (sample, k) the oracle's ids of the first queries
    *,
    reps: int,
) -> list[dict]:
    """Time kernel C2 + each reducer of c=32 candidates + the rescore to
    k=10 over the NB sub-batches and measure recall@10; one row per
    reducer."""
    nb, batch, _ = q8s.shape
    n_super = corpus.shape[0] // T._TURBO_UNIT
    q_pad = [T._pad_query_rows(q, T._I8_QUERY_TILE).contiguous() for q in q8s]
    rows_out = []
    for label, reduce in reducers(n_super).items():
        outs = [None] * nb

        def run(i, reduce=reduce, outs=outs):
            packed = T.i8_turbo_cells(q_pad[i], corpus, slots=2)[:batch]
            cids = reduce(packed, n_docs, common.C)
            outs[i] = T.exact_rescore(rows, qfs[i], cids, common.K)[1]

        med, best = common.time_per_sub_batch(run, nb, reps, corpus.device)
        ids = torch.cat(outs).cpu().numpy()
        rows_out.append({
            "label": label, "ms_median": med, "ms_best": best, "batch": batch,
            "recall": common.recall_at_k(ids, ref_ids),
        })
    return rows_out


def main(argv=None) -> int:
    args = common.parse_args(argv, __doc__)
    reps = int(os.environ.get("AB_REPS", "5"))
    total = args.nb * args.batch
    sample = min(int(os.environ.get("AB_SAMPLE", "128")), total)
    device = torch.device(args.device)
    print(common.device_line(device), flush=True)
    t0 = time.perf_counter()
    emb, q = common.script_corpus(args.n_docs, total, near_docs=True)
    rows, corpus, q8s, qfs = common.device_operands(emb, q, args.nb, args.batch, device)
    del emb
    n_super = corpus.shape[0] // T._TURBO_UNIT
    print(
        f"corpus {args.n_docs}->{corpus.shape[0]} rows ({n_super} supers), "
        f"{args.nb}x{args.batch} queries on {device} ({time.perf_counter() - t0:.1f}s)",
        flush=True,
    )
    t0 = time.perf_counter()
    ref_ids = common.exact_ids(rows, qfs.view(total, -1)[:sample])
    print(f"exact reference over {sample} queries ({time.perf_counter() - t0:.1f}s)", flush=True)
    print(common.clock_note(device, reps, args.nb), flush=True)
    for row in reduce_ab(corpus, rows, q8s, qfs, args.n_docs, ref_ids, reps=reps):
        print(common.row_line(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
