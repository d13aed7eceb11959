"""Exact Okapi BM25 over every posting of the raw CSR arrays.

score(q, d) = sum over the query's distinct terms t of
idf(t) * qtf(t) * tf(t, d) * (k1 + 1) / (tf(t, d) + k1 * (1 - b + b * len(d) / avgdl)),
idf(t) = ln(1 + (N - df(t) + 0.5) / (df(t) + 0.5)). Only docs that match a
query term rank; a filter drops masked docs from the ranking and keeps the
whole corpus's statistics.

A live corpus freezes ``avgdl`` at its base segment's, the first
``n_base`` docs; with ``n_visible`` the statistics are those of the docs
added so far, the first ``n_visible``: N = n_visible and df(t) counts
them, deleted docs included (a delete is a filter). Contributions are summed in float64 on the
device and the sums rounded to float32; with ``low_precision`` each
contribution and each sum is rounded to bfloat16 instead (the control).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from portbench.reference.ranking import NEG_INF, pad_invalid, top_c


class ExactBM25:
    def __init__(
        self,
        term_offsets: np.ndarray,  # (V + 2,) int64; term id t spans [t, t + 1)
        doc_ids: torch.Tensor,  # (nnz,) int32 on the device
        tf: torch.Tensor,  # (nnz,) f32
        doc_len: torch.Tensor,  # (N,) f32
        *,
        k1: float = 1.2,
        b: float = 0.75,
        low_precision: bool = False,
        n_base: Optional[int] = None,  # avgdl over the first n_base docs
    ):
        self.offsets = np.asarray(term_offsets, np.int64)
        self.doc_ids = doc_ids.long()
        self.tf = tf
        self.doc_len = doc_len.double()
        self.n_docs = int(doc_len.shape[0])
        self.avgdl = float(self.doc_len[:n_base].mean())
        self.k1, self.b = k1, b
        df = np.diff(self.offsets).astype(np.float64)
        self.idf = np.log1p((self.n_docs - df + 0.5) / (df + 0.5))
        self.low = low_precision

    def _idf(self, t: int, lo: int, hi: int, n_visible: Optional[int]):
        if n_visible is None:
            return self.idf[t]
        # doc ids ascend within a term: df counts those below n_visible
        df = int(torch.searchsorted(self.doc_ids[lo:hi], n_visible))
        return math.log1p((n_visible - df + 0.5) / (df + 0.5))

    def _term(self, t: int, qtf: int, n_visible: Optional[int] = None):
        lo, hi = int(self.offsets[t]), int(self.offsets[t + 1])
        ids = self.doc_ids[lo:hi]
        tf = self.tf[lo:hi].double()
        norm = self.k1 * (1.0 - self.b + self.b * self.doc_len[ids] / self.avgdl)
        w = self._idf(t, lo, hi, n_visible) * qtf * tf * (self.k1 + 1.0) / (tf + norm)
        if self.low:
            w = w.to(torch.bfloat16).double()
        return ids, w

    def scores(self, queries: Sequence[Sequence[int]], n_visible: Optional[int] = None) -> torch.Tensor:
        """(len(queries), N) float32 scores; 0 where no term matches. With
        ``n_visible``, under the statistics of the first n_visible docs
        (docs past them score too: mask them out)."""
        out = torch.zeros((len(queries), self.n_docs), dtype=torch.float64, device=self.doc_ids.device)
        n_terms = self.offsets.shape[0] - 1
        for row, terms in enumerate(queries):
            for t, qtf in Counter(int(t) for t in terms if 0 < t < n_terms).items():
                ids, w = self._term(t, qtf, n_visible)
                out[row].index_add_(0, ids, w)
        if self.low:
            return out.to(torch.bfloat16).float()
        return out.float()

    def top(
        self,
        queries: Sequence[Sequence[int]],
        c: int,
        masks: Optional[torch.Tensor] = None,  # (len(queries), N) bool
        block: int = 32,
        n_visible: Optional[int] = None,
    ):
        """The exact top-``c`` of each query: ((B, c) f32 scores, (B, c)
        int64 ids), padded with (0.0, -1)."""
        vals, ids = [], []
        for s in range(0, len(queries), block):
            sc = self.scores(queries[s : s + block], n_visible)
            keep = sc > 0
            if masks is not None:
                keep &= masks[s : s + block]
            sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
            v, i = top_c(sc, c)
            v, i = pad_invalid(v, i, c)
            vals.append(v)
            ids.append(i)
        return torch.cat(vals), torch.cat(ids)
