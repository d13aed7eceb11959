"""BM25: host query plan, device segmented sum and top-k.

Port of the reference's ``ops.bm25``. The host half (``QueryPlan``,
``_bucket``, ``encode_query``, ``build_query_plan``) is a copy; it plans
through the port's copy of the C++ planner
(:func:`openintel_tpu_torch.native.native_build_query_plan`) when that is
built, and through the NumPy path otherwise. The device half,
``bm25_topk_device``, keeps the presorted-plan contract and the bounded
Hillis-Steele segmented sum in the same order of adds as the JAX program,
so its sums are bit-identical.

Ranking contract: only docs matching at least one query term rank (scores
are strictly positive); short rankings pad with (0.0, -1); ties break by
ascending doc id.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from openintel_tpu_torch.index.schema import PostingsIndex
from openintel_tpu_torch.ops.tokenizer import tokenize
from openintel_tpu_torch.ops.ranking import stable_topk

NEG_INF = float("-inf")


@dataclass
class QueryPlan:
    """Static-shape batched postings for a query batch."""

    doc_ids: np.ndarray  # (B, P) int32; padding rows point at n_docs (sentinel)
    weights: np.ndarray  # (B, P) float32; padding weight 0
    n_docs: int
    presorted: bool = False  # rows ascending by doc id (host-sorted)
    max_terms: int = 0  # max distinct terms per query = max equal-doc run (0 = unknown)


def _bucket(width: int, minimum: int = 512) -> int:
    """Round a plan width up to the next bucket: powers of two plus their
    1.5x midpoints (512, 768, 1024, 1536, 2048, ...), so device cost stays
    within ~33% of the true width while the set of shapes stays small."""
    p = minimum
    while True:
        if width <= p:
            return p
        if width <= p + p // 2:
            return p + p // 2
        p *= 2


def encode_query(index: PostingsIndex, text: str) -> list[int]:
    """Tokenise query text into term ids over the index vocabulary (unknown
    tokens drop out — they can never score)."""
    get = index.vocab.token_to_id.get
    return [tid for tok in tokenize(text) if (tid := get(tok, 0))]


def build_query_plan(
    index: PostingsIndex,
    queries_term_ids: Sequence[Sequence[int]],
    *,
    max_postings_per_term: int | None = None,
    include_multi_term: bool = True,
    multi_budget: int = 256,
    sort: bool = True,
    use_native: bool = True,
    doc_mask: np.ndarray | None = None,
    n_threads: int = 0,  # native planner threads; 0 = hardware concurrency
) -> QueryPlan:
    """Assemble the padded (doc_id, weight) plan for a batch of queries.

    Same contract as the reference's ``ops.bm25.build_query_plan`` (which
    documents the pruning-exactness argument): ``max_postings_per_term``
    keeps each term's top-M postings by impact, ``include_multi_term``
    forces the top ``multi_budget`` multi-term docs by true score,
    ``doc_mask`` builds a filtered plan, ``sort`` orders each row by doc id
    on the host, and ``use_native`` routes pruned sorted plans through the
    C++ planner when its library is built."""
    if doc_mask is not None:
        doc_mask = np.asarray(doc_mask, dtype=bool)
        if doc_mask.shape != (index.n_docs,):
            raise ValueError(
                f"doc_mask shape {doc_mask.shape} != ({index.n_docs},)"
            )

    def _postings(t: int) -> tuple[np.ndarray, np.ndarray]:
        ids, imp = index.postings(t)
        if doc_mask is None:
            return ids, imp
        keep = doc_mask[ids]
        return ids[keep], imp[keep]

    def _pruned(t: int, m: int) -> tuple[np.ndarray, np.ndarray]:
        if doc_mask is None:
            return index.pruned_postings(t, m)
        # top-m UNMASKED postings by impact: walk the impact-descending
        # permutation under the mask (same tie-breaking as pruned_postings)
        order = index.ensure_impact_order()
        lo = int(index.term_offsets[t])
        hi = int(index.term_offsets[t + 1])
        sel = order[lo:hi]
        sel = sel[doc_mask[index.doc_ids[sel]]][:m]
        return index.doc_ids[sel], index.impact[sel]

    if use_native and sort and max_postings_per_term is not None:
        from openintel_tpu_torch import native

        res = native.native_build_query_plan(
            index,
            queries_term_ids,
            max_postings_per_term,
            multi_budget if include_multi_term else 0,
            n_threads=n_threads,
            doc_mask=doc_mask,
        )
        if res is not None:
            out_ids, out_w, max_terms, max_width = res
            width = _bucket(max(max_width, 1))
            if width <= out_ids.shape[1]:
                out_ids, out_w = out_ids[:, :width], out_w[:, :width]
            else:
                pad = width - out_ids.shape[1]
                out_ids = np.pad(
                    out_ids, ((0, 0), (0, pad)), constant_values=index.n_docs
                )
                out_w = np.pad(out_w, ((0, 0), (0, pad)))
            return QueryPlan(
                doc_ids=np.ascontiguousarray(out_ids),
                weights=np.ascontiguousarray(out_w),
                n_docs=index.n_docs,
                presorted=True,
                max_terms=max_terms,
            )

    rows_ids: list[np.ndarray] = []
    rows_w: list[np.ndarray] = []
    n_term_slots = index.term_offsets.shape[0] - 1
    max_terms = 1
    for terms in queries_term_ids:
        qtf: dict[int, int] = {}
        for t in terms:
            if 0 < t < n_term_slots:  # drop padding + out-of-vocab ids
                qtf[t] = qtf.get(t, 0) + 1
        max_terms = max(max_terms, len(qtf))
        prune = (
            max_postings_per_term is not None
            and any(index.df[t] > max_postings_per_term for t in qtf)
        )
        multi_docs = None
        if prune and include_multi_term and len(qtf) > 1:
            term_data = {t: _postings(int(t)) for t in qtf}
            alldocs = np.concatenate([term_data[t][0] for t in qtf])
            sd = np.sort(alldocs)
            multi_docs = np.unique(sd[1:][sd[1:] == sd[:-1]])
            if multi_docs.size > multi_budget:
                # exact host scoring of the multi-term docs, keep the top
                # multi_budget by true score
                mscores = np.zeros(multi_docs.size, np.float64)
                for t, count in qtf.items():
                    fids, fimp = term_data[t]
                    if fids.size == 0:  # df=0 under a shared cross-shard vocab
                        continue
                    pos = np.minimum(
                        np.searchsorted(fids, multi_docs), fids.size - 1
                    )
                    hit = fids[pos] == multi_docs
                    mscores[hit] += fimp[pos[hit]] * (
                        float(index.idf[t]) * count
                    )
                # ties: score desc then doc asc — matches planner.cpp exactly
                keep = np.lexsort((multi_docs, -mscores))[:multi_budget]
                multi_docs = np.sort(multi_docs[keep])
        parts_ids = []
        parts_w = []
        for t, count in qtf.items():
            if prune:
                ids, impacts = _pruned(int(t), max_postings_per_term)
                if multi_docs is not None and multi_docs.size:
                    fids, fimp = term_data[t]  # fetched during multi scoring
                    forced = np.flatnonzero(
                        np.isin(fids, multi_docs, assume_unique=True)
                    )
                    keep = np.union1d(ids, fids[forced])
                    sel = np.searchsorted(fids, keep)
                    ids, impacts = keep.astype(np.int32), fimp[sel]
            else:
                ids, impacts = _postings(int(t))
            parts_ids.append(ids)
            parts_w.append(impacts * (float(index.idf[t]) * count))
        if parts_ids:
            rows_ids.append(np.concatenate(parts_ids))
            rows_w.append(np.concatenate(parts_w).astype(np.float32))
        else:
            rows_ids.append(np.zeros(0, np.int32))
            rows_w.append(np.zeros(0, np.float32))

    width = _bucket(max((len(r) for r in rows_ids), default=1))
    b = len(rows_ids)
    doc_ids = np.full((b, width), index.n_docs, dtype=np.int32)  # sentinel row
    weights = np.zeros((b, width), dtype=np.float32)
    for i, (ids, w) in enumerate(zip(rows_ids, rows_w)):
        doc_ids[i, : len(ids)] = ids
        weights[i, : len(w)] = w
    if sort:
        order = np.argsort(doc_ids, axis=1, kind="stable")
        doc_ids = np.take_along_axis(doc_ids, order, axis=1)
        weights = np.take_along_axis(weights, order, axis=1)
    return QueryPlan(
        doc_ids=doc_ids,
        weights=weights,
        n_docs=index.n_docs,
        presorted=sort,
        max_terms=max_terms,
    )


def bm25_topk_device(
    doc_ids: torch.Tensor,  # (B, P) int32 with sentinel n_docs padding
    weights: torch.Tensor,  # (B, P) f32
    n_docs: int,
    k: int,
    presorted: bool = False,
    max_run: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter-free BM25 top-k: sort by doc id, segmented-sum, reduce.

    ``presorted`` skips the sort when rows are already ascending by doc id
    (``build_query_plan(..., sort=True)``, the production path).
    ``max_run`` bounds the longest equal-doc run (``QueryPlan.max_terms``),
    so the Hillis-Steele scan needs only ceil(log2(max_run)) shift steps;
    0 means unbounded.

    Returns (vals (B, k) f32, ids (B, k) int32); rows with fewer than k
    matching docs pad with (0.0, -1)."""
    if presorted:
        d, w = doc_ids, weights
    else:
        order = torch.sort(doc_ids, dim=1, stable=True).indices
        d = torch.gather(doc_ids, 1, order)
        w = torch.gather(weights, 1, order)

    p = d.shape[1]
    run = max_run if 0 < max_run <= p else p
    # Segmented inclusive scan (Hillis-Steele): rows are sorted, so
    # d[i-s] == d[i] implies one run covers [i-s, i]; after the j-th step
    # each element holds the sum of up to 2^(j+1) run elements ending at it.
    seg = w
    shift = 1
    while shift < run:
        d_prev = torch.nn.functional.pad(d, (shift, 0), value=-1)[:, :p]
        s_prev = torch.nn.functional.pad(seg, (shift, 0))[:, :p]
        seg = seg + torch.where(d_prev == d, s_prev, torch.zeros_like(s_prev))
        shift *= 2
    nxt = torch.cat([d[:, 1:], torch.full_like(d[:, :1], -2)], dim=1)
    is_last = d != nxt  # last element of each equal-doc run holds the total
    masked = torch.where(
        is_last & (d < n_docs) & (seg > 0.0), seg, torch.full_like(seg, NEG_INF)
    )
    vals, sel = stable_topk(masked, min(k, p))
    ids = torch.gather(d, 1, sel)
    if k > p:  # plan narrower than k: pad columns
        vals = torch.nn.functional.pad(vals, (0, k - p), value=NEG_INF)
        ids = torch.nn.functional.pad(ids, (0, k - p), value=0)
    pad = vals == NEG_INF
    return (
        torch.where(pad, torch.zeros_like(vals), vals),
        torch.where(pad, torch.full_like(ids, -1), ids).to(torch.int32),
    )
