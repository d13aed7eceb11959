"""Index build pipeline: tokenise -> postings + stats.

The port's copy of :mod:`openintel_tpu.index.build`. The host does the
irregular work (tokenisation, CSR assembly, optionally through the port's
C++ streaming tokeniser); everything downstream is fixed-shape arrays for
the device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from openintel_tpu_torch.index.schema import BM25Config, PostingsIndex
from openintel_tpu_torch.ops.tokenizer import Vocab, tokenize_batch


def bm25_idf(df: np.ndarray, n_docs: int) -> np.ndarray:
    """Lucene-style always-positive idf: ln(1 + (N - df + 0.5)/(df + 0.5))."""
    df = np.asarray(df, dtype=np.float64)
    return np.log1p((n_docs - df + 0.5) / (df + 0.5)).astype(np.float32)


def bm25_impact(
    tf: np.ndarray, doc_len: np.ndarray, avgdl: float, cfg: BM25Config
) -> np.ndarray:
    """Length-normalised saturated tf: tf*(k1+1) / (tf + k1*(1-b+b*dl/avgdl))."""
    tf = np.asarray(tf, dtype=np.float64)
    dl = np.asarray(doc_len, dtype=np.float64)
    denom = tf + cfg.k1 * (1.0 - cfg.b + cfg.b * dl / max(avgdl, 1e-12))
    return (tf * (cfg.k1 + 1.0) / denom).astype(np.float32)


def build_postings_index(
    texts: Sequence[str],
    *,
    vocab: Optional[Vocab] = None,
    config: BM25Config = BM25Config(),
    use_native: bool = True,
    avgdl_override: Optional[float] = None,
    pretokenized: Optional[Sequence[Sequence[str]]] = None,
) -> PostingsIndex:
    """Build a term-major CSR postings index with fused impacts.

    When ``vocab`` is given (e.g. a shared vocabulary across shards), only its
    terms are indexed; otherwise the vocabulary is built from the corpus.
    Pure-ASCII corpora with no fixed vocab stream through the C++ builder
    (openintel_tpu_torch/native/postings.cpp) when it is built — identical output,
    asserted in tests.

    ``avgdl_override`` bakes the given avgdl into the fused impacts instead
    of this corpus's own mean (incremental delta segments freeze the base
    index's avgdl so scores stay comparable).
    ``pretokenized`` skips tokenisation when the caller already holds the
    token lists (must align with ``texts``)."""
    if (
        vocab is None and use_native and avgdl_override is None
        and pretokenized is None
    ):
        try:
            from openintel_tpu_torch import native

            raw = native.native_build_postings(texts)
        except (ImportError, OSError, AttributeError) as e:
            # library missing/stale ABI: degrade to the Python builder, but
            # never silently — the native path is 12x faster
            import sys

            print(
                f"warning: native postings builder unavailable ({e}); "
                "falling back to the Python builder",
                file=sys.stderr,
            )
            raw = None
        if raw is not None:
            term_offsets, doc_ids, tf, doc_len, df, vocab_map = raw
            n_docs = len(texts)
            avgdl = float(doc_len.astype(np.float64).mean()) if n_docs else 0.0
            impact = (
                bm25_impact(tf, doc_len[doc_ids], avgdl, config)
                if len(tf)
                else np.zeros(0, np.float32)
            )
            return PostingsIndex(
                term_offsets=term_offsets,
                doc_ids=doc_ids,
                tf=tf,
                impact=impact,
                df=df,
                idf=bm25_idf(df, n_docs),
                doc_len=doc_len,
                avgdl=avgdl,
                n_docs=n_docs,
                vocab=Vocab(token_to_id=vocab_map),
                config=config,
            )

    token_lists = (
        list(pretokenized) if pretokenized is not None else tokenize_batch(texts)
    )
    if vocab is None:
        vocab = Vocab.build(token_lists)

    n_docs = len(token_lists)
    doc_len = np.array([len(t) for t in token_lists], dtype=np.float32)
    avgdl = float(doc_len.astype(np.float64).mean()) if n_docs else 0.0
    if avgdl_override is not None:
        avgdl = float(avgdl_override)

    # Count (term, doc) pairs. Unknown tokens (id 0) count toward doc_len but
    # never enter the postings (they can never be queried).
    v_size = vocab.size
    counts_per_term: list[dict[int, int]] = [dict() for _ in range(v_size)]
    get = vocab.token_to_id.get
    for d, tokens in enumerate(token_lists):
        for tok in tokens:
            tid = get(tok, 0)
            if tid:
                bucket = counts_per_term[tid]
                bucket[d] = bucket.get(d, 0) + 1

    term_offsets = np.zeros(v_size + 1, dtype=np.int64)
    df = np.zeros(v_size, dtype=np.int32)
    chunks_ids: list[np.ndarray] = []
    chunks_tf: list[np.ndarray] = []
    for tid in range(v_size):
        bucket = counts_per_term[tid]
        df[tid] = len(bucket)
        term_offsets[tid + 1] = term_offsets[tid] + len(bucket)
        if bucket:
            ids = np.fromiter(sorted(bucket), dtype=np.int32, count=len(bucket))
            tfs = np.array([bucket[int(i)] for i in ids], dtype=np.float32)
            chunks_ids.append(ids)
            chunks_tf.append(tfs)

    doc_ids = np.concatenate(chunks_ids) if chunks_ids else np.zeros(0, np.int32)
    tf = np.concatenate(chunks_tf) if chunks_tf else np.zeros(0, np.float32)
    impact = (
        bm25_impact(tf, doc_len[doc_ids], avgdl, config)
        if len(tf)
        else np.zeros(0, np.float32)
    )

    return PostingsIndex(
        term_offsets=term_offsets,
        doc_ids=doc_ids,
        tf=tf,
        impact=impact,
        df=df,
        idf=bm25_idf(df, n_docs),
        doc_len=doc_len,
        avgdl=avgdl,
        n_docs=n_docs,
        vocab=vocab,
        config=config,
    )
