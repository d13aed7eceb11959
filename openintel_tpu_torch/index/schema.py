"""Index schema: CSR postings over terms, dense embedding index, BM25 stats.

The port's copy of :mod:`openintel_tpu.index.schema`, with the same
fields and dtypes, so the on-disk checkpoint pair stays one format for
both packages:

- postings are term-major CSR (term_offsets / doc_ids / tf), doc ids
  ascending within each term, with per-posting *impacts* (the
  length-normalised saturated tf) precomputed at build time, so query-time
  work is a gather-scale-reduce: contribution = idf(t) * qtf * impact(t, d);
- the dense index stores L2-normalised embeddings, so cosine == dot, in
  float32 or bfloat16. The port does not depend on ``ml_dtypes``, so its
  bf16 rows live in a CPU torch tensor; an index carried from the JAX
  package may hold ``ml_dtypes`` bf16 rows, which the port reads through a
  16-bit view (``convert.stored_rows``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from openintel_tpu_torch.ops.tokenizer import Vocab
from openintel_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class BM25Config:
    """Okapi BM25 constants. idf = ln(1 + (N - df + 0.5)/(df + 0.5)) (always
    positive, Lucene-style); sat(tf, dl) = tf*(k1+1) / (tf + k1*(1 - b + b*dl/avgdl))."""

    k1: float = 1.2
    b: float = 0.75


@dataclass
class PostingsIndex:
    """Term-major CSR postings with fused impacts.

    ``impact_order`` optionally holds, per term segment, the absolute posting
    indices sorted by (-impact, doc_id) — the impact-ordered view used for
    top-M pruned scoring at scale (the impact-sorted-index technique: common
    query terms contribute only their M highest-impact postings, bounding the
    device plan width while keeping recall@k near-exact)."""

    term_offsets: np.ndarray  # (V+1,) int64 — CSR row pointers per term id
    doc_ids: np.ndarray  # (nnz,) int32 — ascending within each term
    tf: np.ndarray  # (nnz,) float32 — raw term frequencies
    impact: np.ndarray  # (nnz,) float32 — sat(tf, doc_len) precomputed
    df: np.ndarray  # (V,) int32
    idf: np.ndarray  # (V,) float32
    doc_len: np.ndarray  # (N,) float32
    avgdl: float
    n_docs: int
    vocab: Vocab
    config: BM25Config
    impact_order: Optional[np.ndarray] = None  # (nnz,) int64, lazy
    # max_m -> (offsets, doc_ids, impacts): per-term doc-sorted top-M view
    # consumed by the C++ planner's emit phase (pruned_cache); lazy
    _pruned_cache: Optional[dict] = None
    # min_df -> (slots (V,) i32, words (n_big, ceil(N/64)) u64): postings
    # membership bitmaps for high-df terms (bitmap_cache); lazy
    _bitmap_cache: Optional[dict] = None

    @property
    def nnz(self) -> int:
        return int(self.doc_ids.shape[0])

    def postings(self, term_id: int) -> tuple[np.ndarray, np.ndarray]:
        """(doc_ids, impacts) slice for one term id."""
        lo, hi = int(self.term_offsets[term_id]), int(self.term_offsets[term_id + 1])
        return self.doc_ids[lo:hi], self.impact[lo:hi]

    def ensure_impact_order(self) -> np.ndarray:
        """Build (or return) the per-term impact-descending permutation.

        The order of one global lexsort keyed (term, -impact, doc), built
        as one stable sort of a single int64 key per posting, ``term << 32
        | descending impact bits`` (:func:`_impact_key`): doc ids ascend
        within each term, so a stable sort breaks impact ties by doc as
        the lexsort does. Where an impact is NaN (the lexsort puts it
        last in its term), the impacts are not float32, or the doc ids do
        not ascend within a term, the lexsort runs itself. The span's
        ``route`` attribute says which ran: ``"key"`` or ``"lexsort"``."""
        if self.impact_order is None:
            if self.nnz == 0:
                self.impact_order = np.zeros(0, dtype=np.int64)
                return self.impact_order
            with span("setup.impact_order", n=self.nnz) as s:
                seg_lens = np.diff(self.term_offsets).astype(np.int64)
                term_of = np.repeat(
                    np.arange(seg_lens.shape[0], dtype=np.int64), seg_lens
                )
                keyed = (
                    self.impact.dtype == np.float32
                    and not np.isnan(self.impact).any()
                    and self._docs_ascend()
                )
                s.attrs["route"] = "key" if keyed else "lexsort"
                if keyed:
                    key = torch.from_numpy(_impact_key(term_of, self.impact))
                    self.impact_order = torch.argsort(key, stable=True).numpy()
                else:
                    self.impact_order = np.lexsort(
                        (self.doc_ids, -self.impact, term_of)
                    ).astype(np.int64)
        return self.impact_order

    def _docs_ascend(self) -> bool:
        """Whether doc ids strictly ascend within every term segment, as
        the index builds make them: each step down, or repeat, falls on a
        segment's start."""
        d = self.doc_ids
        at = np.flatnonzero(d[1:] <= d[:-1]) + 1
        return bool(np.isin(at, self.term_offsets).all())

    def pruned_postings(
        self, term_id: int, max_m: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """(doc_ids, impacts) of the term's top-``max_m`` postings by impact."""
        order = self.ensure_impact_order()
        lo, hi = int(self.term_offsets[term_id]), int(self.term_offsets[term_id + 1])
        sel = order[lo : min(hi, lo + max_m)]
        return self.doc_ids[sel], self.impact[sel]

    def pruned_cache(
        self, max_m: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every term's top-``max_m``-by-impact postings, doc-ascending, as
        one contiguous CSR triple (offsets (V+1,) i64, doc_ids i32,
        impacts f32).

        The C++ planner's emit phase reads a pruned term's contribution
        straight from these slices (a linear copy) instead of three
        dependent random gathers per posting through ``impact_order`` plus
        a per-term sort — measured ~20% of plan-build cost at bench scale.
        The selected SET per term is identical to :meth:`pruned_postings`
        (same (-impact, doc) tie-breaking); only the emission order differs,
        and plan rows are doc-sorted afterwards either way. Built once per
        distinct ``max_m`` and memoized on the index."""
        if self._pruned_cache is None:
            self._pruned_cache = {}
        hit = self._pruned_cache.get(max_m)
        if hit is not None:
            return hit
        order = self.ensure_impact_order()
        with span("setup.pruned_cache", n=self.nnz, max_m=max_m) as s:
            seg = np.diff(self.term_offsets).astype(np.int64)
            take = np.minimum(seg, max_m)
            offs = np.concatenate(
                [np.zeros(1, np.int64), np.cumsum(take, dtype=np.int64)]
            )
            if self.nnz and offs[-1] > 0:
                pos_in_seg = np.arange(self.nnz, dtype=np.int64) - np.repeat(
                    self.term_offsets[:-1].astype(np.int64), seg
                )
                sel = order[pos_in_seg < np.repeat(take, seg)]
                ascend = self._docs_ascend()
                s.attrs["route"] = "mask" if ascend else "lexsort"
                if ascend:
                    # the postings are already term-major and doc-ascending:
                    # marking the selected positions and compacting keeps
                    # that order without a sort
                    keep = np.zeros(self.nnz, dtype=bool)
                    keep[sel] = True
                    docs, imps = self.doc_ids[keep], self.impact[keep]
                else:
                    docs, imps = self.doc_ids[sel], self.impact[sel]
                    term_of = np.repeat(np.arange(seg.shape[0], dtype=np.int64), take)
                    o2 = np.lexsort((docs, term_of))
                    docs, imps = docs[o2], imps[o2]
                docs = np.ascontiguousarray(docs, dtype=np.int32)
                imps = np.ascontiguousarray(imps, dtype=np.float32)
            else:
                docs = np.zeros(0, np.int32)
                imps = np.zeros(0, np.float32)
        out = (offs, docs, imps)
        self._pruned_cache[max_m] = out
        return out

    def bitmap_cache(
        self, min_df: int
    ) -> tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """Postings membership bitmaps for every term with df >= ``min_df``:
        (slots (V,) int32 — bitmap row index or -1, words (n_big,
        ceil(N/64)) uint64 little-bit-order).

        Consumed by the C++ planner's multi-term phase: intersecting a pair
        whose larger side has a bitmap costs O(smaller-df) sequential bit
        probes (the smaller list is ascending, so probes stream through the
        row) instead of the O(df_a + df_b) SIMD merge — the merge was 51%
        of plan-assembly cost at bench scale, concentrated in comparable-
        size high-df pairs. Memory is bounded by the df threshold (~46 MB
        at 1.25M docs / min_df 8192). Returns (None, None) when no term
        qualifies. Built once per distinct ``min_df`` and memoized."""
        if self._bitmap_cache is None:
            self._bitmap_cache = {}
        hit = self._bitmap_cache.get(min_df)
        if hit is not None:
            return hit
        with span("setup.bitmap_cache", n=self.nnz, min_df=min_df):
            out = self._bitmaps(min_df)
        self._bitmap_cache[min_df] = out
        return out

    def _bitmaps(self, min_df: int):
        df = np.diff(self.term_offsets)
        big = np.flatnonzero(df >= min_df)
        if big.shape[0] == 0 or self.n_docs == 0:
            return None, None
        stride = (self.n_docs + 63) // 64
        slots = np.full(df.shape[0], -1, np.int32)
        slots[big] = np.arange(big.shape[0], dtype=np.int32)
        words = np.zeros((big.shape[0], stride), np.uint64)
        for s, t in enumerate(big):
            lo, hi = int(self.term_offsets[t]), int(self.term_offsets[t + 1])
            docs = self.doc_ids[lo:hi].astype(np.int64)
            widx = docs >> 6
            bits = np.uint64(1) << (docs & 63).astype(np.uint64)
            # docs ascending & unique -> widx is sorted; OR each equal-word
            # run in one reduceat pass
            starts = np.flatnonzero(np.r_[True, np.diff(widx) != 0])
            words[s, widx[starts]] = np.bitwise_or.reduceat(bits, starts)
        return slots, words


def _impact_key(term_of: np.ndarray, impact: np.ndarray) -> np.ndarray:
    """One int64 sort key per posting, ascending in (term, -impact), made
    in place of ``term_of``: ``term << 32 | d``, where ``d`` is the float32
    impact's bits as a uint32 that falls as the impact rises (a
    non-negative's ``0x7FFFFFFF - bits``, a negative's bits as they are).
    -0.0 becomes +0.0 first, so that the two tie as they compare. The
    impacts must hold no NaN."""
    s = (impact + np.float32(0.0)).view(np.int32)  # -0.0 + 0.0 is +0.0
    s ^= ~(s >> 31) & np.int32(0x7FFFFFFF)
    term_of <<= 32
    term_of |= s.view(np.uint32)
    return term_of


def dense_store_dtype(name: str):
    """Map the user-facing dense storage choice to a dtype: ``f32`` ->
    numpy float32, ``bf16`` -> ``torch.bfloat16`` (the reference's
    ``ml_dtypes.bfloat16``, which the port does not need). ``bf16`` halves
    index memory; ``f32`` is the recall-critical deployment switch."""
    if name == "f32":
        return np.dtype(np.float32)
    if name == "bf16":
        return torch.bfloat16
    raise ValueError(f"unknown dense store {name!r} (choices: f32, bf16)")


def dense_store_name(dtype) -> str:
    """Inverse of :func:`dense_store_dtype` for checkpoint meta: f32 or bf16
    as a numpy or torch dtype (an ``ml_dtypes`` bf16 numpy dtype included);
    unknown dtypes report their name verbatim."""
    if dtype in (torch.float32, torch.bfloat16):
        return "f32" if dtype == torch.float32 else "bf16"
    dt = np.dtype(dtype)
    if dt == np.float32:
        return "f32"
    if dt.name == "bfloat16":
        return "bf16"
    return dt.name


@dataclass
class DenseIndex:
    """L2-normalised document embeddings; cosine similarity == dot product."""

    # (N, D) unit-norm rows: a float32 numpy array or a CPU torch tensor of
    # float32 or bfloat16 (a JAX-built index may hold ml_dtypes bf16 rows)
    embeddings: object
    n_docs: int
    dim: int

    @staticmethod
    def from_embeddings(raw: np.ndarray, *, dtype=np.float32) -> "DenseIndex":
        """The reference's float32 normalisation; rows stored as numpy
        float32 (``np.float32``) or as a CPU torch tensor (``torch.float32``,
        ``torch.bfloat16``; bf16 rounds to nearest even, as ``ml_dtypes``)."""
        raw = np.asarray(raw, dtype=np.float32)
        norms = np.linalg.norm(raw, axis=1, keepdims=True)
        normed = raw / np.maximum(norms, 1e-12)
        if isinstance(dtype, torch.dtype):
            rows = torch.from_numpy(normed).to(dtype)
        else:
            rows = normed.astype(dtype)
        return DenseIndex(embeddings=rows, n_docs=raw.shape[0], dim=raw.shape[1])
