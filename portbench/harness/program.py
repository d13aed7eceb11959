"""The system under test, built from the benchmark's inputs: the only module
of the harness that imports ``openintel_tpu_torch`` to construct it.

The program derives what it derives in deployment: BM25 impacts and idf
(``index.build``), the impact order and the planner's caches (at the
first plans, in the warm-up), the int8 candidate copy of the stored rows
(``DenseRetriever``). Its native planner is built by its own ``native.build``
into the checkout's ``build/`` on a run's first call.
"""

from __future__ import annotations

import numpy as np

from portbench.harness.data import PoolEmbedder, Postings, QueryPool


def build_native() -> None:
    from openintel_tpu_torch import native

    native.build()
    native.install()


def postings_index(p: Postings, vocab: int):
    from openintel_tpu_torch.index.build import bm25_idf, bm25_impact
    from openintel_tpu_torch.index.schema import BM25Config, PostingsIndex
    from openintel_tpu_torch.ops.tokenizer import Vocab

    n_docs = p.doc_len.shape[0]
    cfg = BM25Config()
    avgdl = float(p.doc_len.astype(np.float64).mean())
    df = np.diff(p.offsets).astype(np.int32)  # slot 0: the padding term
    return PostingsIndex(
        term_offsets=p.offsets,
        doc_ids=p.doc_ids,
        tf=p.tf,
        impact=bm25_impact(p.tf, p.doc_len[p.doc_ids], avgdl, cfg),
        df=df,
        idf=bm25_idf(df, n_docs),
        doc_len=p.doc_len,
        avgdl=avgdl,
        n_docs=n_docs,
        vocab=Vocab(token_to_id={f"t{i}": i + 1 for i in range(vocab)}),
        config=cfg,
    )


def dense_index(rows):
    from openintel_tpu_torch.index.schema import DenseIndex

    return DenseIndex(embeddings=rows, n_docs=int(rows.shape[0]), dim=int(rows.shape[1]))


def hybrid_retriever(cfg: dict, postings: Postings, rows, pool: QueryPool, device):
    from openintel_tpu_torch.models.retrievers import HybridRetriever

    return HybridRetriever(
        postings_index(postings, cfg["vocab_size"]),
        dense_index(rows),
        PoolEmbedder(pool),
        fusion=cfg["fusion"],
        blend_alpha=cfg["blend_alpha"],
        kernel=cfg["kernel"],
        device_batch=cfg["device_batch"],
        device=device,
    )


def updatable_retriever(cfg: dict, postings: Postings, rows, pool: QueryPool, device):
    """The live corpus (``UpdatableHybridRetriever``, RRF) over a base
    segment of ``postings`` and ``rows``; its drivers add and delete
    through ``add_documents`` and ``delete_ids``."""
    from openintel_tpu_torch.models.updatable import UpdatableHybridRetriever

    return UpdatableHybridRetriever(
        postings_index(postings, cfg["vocab_size"]),
        dense_index(rows),
        PoolEmbedder(pool),
        kernel=cfg["kernel"],
        device_batch=cfg["device_batch"],
        device=device,
    )


def dense_retriever(cfg: dict, rows, pool: QueryPool, device):
    from openintel_tpu_torch.models.retrievers import DenseRetriever

    return DenseRetriever(dense_index(rows), PoolEmbedder(pool), kernel=cfg["kernel"], device=device)


def server_candidates(k: int) -> int:
    """The candidates an arm the MCP server asks for at k (``mcp/server.py``,
    ``build_server``)."""
    return 2 * k


def coalesced_search(retriever, max_batch: int, max_wait_ms: float):
    """The MCP server's production serving: hybrid searches at
    :func:`server_candidates` behind a ``BatchCoalescer``."""
    from openintel_tpu_torch.serving import BatchCoalescer

    def _hybrid_search(queries, k=10, **filter_kw):
        return retriever.search(queries, k=k, candidates_per_arm=server_candidates(k), **filter_kw)

    return BatchCoalescer(_hybrid_search, max_batch=max_batch, max_wait_ms=max_wait_ms)


def search_corpus(retriever, coalescer, queries: list, k: int):
    """One ``search_corpus`` tool call (JSON-RPC framing left out); returns
    ((len(queries), k) ids, scores), padded with (-1, 0)."""
    from openintel_tpu_torch.mcp.tools import run_search_corpus

    out = run_search_corpus({"queries": queries, "k": k}, retriever, coalescer=coalescer)
    ids = np.full((len(queries), k), -1, np.int64)
    scores = np.zeros((len(queries), k), np.float64)
    for i, row in enumerate(out["results"]):
        for j, hit in enumerate(row["hits"][:k]):
            ids[i, j], scores[i, j] = hit["doc_id"], hit["score"]
    return ids, scores


def pipelined(retriever, depth: int):
    from openintel_tpu_torch.serving import PipelinedSearcher

    return PipelinedSearcher(retriever, depth=depth)


def encode_query(retriever, text: str) -> list[int]:
    from openintel_tpu_torch.ops.bm25 import encode_query as enc

    return enc(retriever.bm25.index, text)
