"""Synthetic corpora for scale tests and benchmarks (BEIR-scale analogue).

The port's copy of the retrieval generators of
:mod:`openintel_tpu.index.synthetic` (the encoder-training families stay
with the reference); same seeds, same arrays. Deterministic given a seed: Zipf-distributed token streams over a configurable
vocabulary plus unit-norm embeddings, with query generators that draw terms
from documents (so BM25 has signal) and embeddings near document vectors (so
dense recall is measurable).
"""

from __future__ import annotations

import numpy as np


def _zipf_probs(vocab_size: int, s: float = 1.1) -> np.ndarray:
    """Zipf rank probabilities (shared by the token corpus and the direct
    CSR generator so the two stay statistically equivalent)."""
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks**s
    return probs / probs.sum()


def synthetic_token_corpus(
    n_docs: int,
    *,
    vocab_size: int = 30_000,
    mean_len: int = 24,
    seed: int = 0,
) -> list[str]:
    """Zipf-ish synthetic posts as whitespace-joined pseudo-tokens ("t123")."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.poisson(mean_len, size=n_docs), 3, 4 * mean_len)
    # one draw for ALL tokens (a per-doc rng.choice re-preprocesses the
    # vocab-size probability vector n_docs times), then split by document
    all_ids = rng.choice(
        vocab_size, size=int(lengths.sum()), p=_zipf_probs(vocab_size)
    )
    bounds = np.cumsum(lengths)[:-1]
    return [
        " ".join(f"t{i}" for i in ids) for ids in np.split(all_ids, bounds)
    ]


def synthetic_queries_from_docs(
    docs: list[str], n_queries: int, *, terms_per_query: int = 4, seed: int = 1
) -> list[str]:
    """Queries sampled from document tokens so lexical retrieval has signal."""
    rng = np.random.default_rng(seed)
    queries = []
    doc_idx = rng.integers(0, len(docs), size=n_queries)
    for d in doc_idx:
        tokens = docs[int(d)].split()
        take = min(terms_per_query, len(tokens))
        queries.append(" ".join(rng.choice(tokens, size=take, replace=False)))
    return queries


def synthetic_embeddings(
    n_docs: int, dim: int = 384, *, seed: int = 2, dtype=np.float32
) -> np.ndarray:
    """Unit-norm random document embeddings."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n_docs, dim)).astype(np.float32)
    e /= np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    return e.astype(dtype)


def synthetic_query_embeddings(
    doc_emb: np.ndarray,
    n_queries: int,
    *,
    noise: float = 0.6,
    seed: int = 3,
) -> tuple[np.ndarray, np.ndarray]:
    """Query embeddings near random docs; returns (queries, target_doc_ids)."""
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, doc_emb.shape[0], size=n_queries)
    q = doc_emb[targets].astype(np.float32) + noise * rng.standard_normal(
        (n_queries, doc_emb.shape[1])
    ).astype(np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    return q, targets.astype(np.int32)


def synthetic_postings_index(
    n_docs: int,
    *,
    vocab_size: int = 30_000,
    mean_len: int = 24,
    seed: int = 0,
):
    """Build a bench-scale PostingsIndex directly as CSR arrays (no host
    tokenisation) — statistically equivalent to a Zipf token corpus, used to
    benchmark query-time scoring at 1M+ docs without waiting on index build."""
    from openintel_tpu_torch.index.build import bm25_idf, bm25_impact
    from openintel_tpu_torch.index.schema import BM25Config, PostingsIndex
    from openintel_tpu_torch.ops.tokenizer import Vocab

    rng = np.random.default_rng(seed)
    probs = _zipf_probs(vocab_size)

    # Per-term presence probability min(1, p*L) — deliberately the
    # first-order UPPER bound on the Poisson presence 1 - exp(-p*L): top
    # Zipf terms saturate to df = n_docs (presence 1.0 vs ~0.92 under the
    # exact model) and mid-rank terms run ~25% denser. The bench corpus is
    # therefore HARDER than a real Zipf token corpus (wider stop-word
    # postings -> wider pruned plans), keeping measured throughput
    # conservative; kept as-is for cross-round bench comparability.
    lam = probs * mean_len
    df = np.minimum(
        np.maximum(rng.binomial(n_docs, np.minimum(1.0, lam)), 0), n_docs
    ).astype(np.int64)
    nnz = int(df.sum())

    offs = np.concatenate([[0], np.cumsum(df)]).astype(np.int64)
    doc_ids = np.empty(nnz, dtype=np.int32)
    exact = n_docs <= 50_000  # exact sampling for tests; fast path at bench scale
    widths = np.zeros(vocab_size, dtype=np.int64)
    for t in range(vocab_size):
        lo, hi = offs[t], offs[t + 1]
        if hi > lo:
            if exact:
                ids = np.sort(rng.choice(n_docs, size=hi - lo, replace=False))
            else:
                # sample-with-replacement then dedupe: a real CSR index never
                # holds duplicate (term, doc) postings (tf aggregates them)
                ids = np.unique(rng.integers(0, n_docs, size=hi - lo))
            widths[t] = len(ids)
            doc_ids[lo : lo + len(ids)] = ids.astype(np.int32)
    # compact to deduped widths
    new_offs = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
    compact = np.empty(int(new_offs[-1]), dtype=np.int32)
    for t in range(vocab_size):
        compact[new_offs[t] : new_offs[t + 1]] = doc_ids[
            offs[t] : offs[t] + widths[t]
        ]
    doc_ids, offs = compact, new_offs
    df = widths.astype(np.int64)
    nnz = int(df.sum())
    # CSR row pointers: slot 0 is the padding term (empty postings).
    term_offsets = np.zeros(vocab_size + 2, dtype=np.int64)
    term_offsets[2:] = offs[1:]
    # Realistic within-doc term frequencies: geometric (power-law-ish tail),
    # mean ~1.7 — NOT flat. Flat tf makes every posting's impact identical,
    # the degenerate worst case for impact-ordered pruning; real corpora are
    # skewed, which is what makes impact-sorted indexes work.
    tf = rng.geometric(0.6, size=nnz).astype(np.float32)

    # Lognormal doc lengths (heavy right tail), mean ~= mean_len.
    sigma = 0.8
    doc_len = np.maximum(
        rng.lognormal(np.log(mean_len) - sigma**2 / 2, sigma, size=n_docs), 3.0
    ).astype(np.float32)
    avgdl = float(doc_len.astype(np.float64).mean())
    cfg = BM25Config()
    vocab = Vocab(token_to_id={f"t{i}": i + 1 for i in range(vocab_size)})
    df_full = np.zeros(vocab_size + 1, dtype=np.int32)
    df_full[1:] = df
    return PostingsIndex(
        term_offsets=term_offsets,
        doc_ids=doc_ids,
        tf=tf,
        impact=bm25_impact(tf, doc_len[doc_ids], avgdl, cfg),
        df=df_full,
        idf=bm25_idf(df_full, n_docs),
        doc_len=doc_len,
        avgdl=avgdl,
        n_docs=n_docs,
        vocab=vocab,
        config=cfg,
    )
