"""Retriever families of the port: BM25, dense cosine, and the hybrid.

Port of the reference's ``models.retrievers`` (unfiltered). The retrievers
own the index tensors on one device, encode queries and run the hybrid
step per query sub-batch: host BM25 plan, dense candidates (kernel A plus
exact rescore at 100k docs and more, kernel B below that; opt-in, kernel D
with ``kernel="fast"`` and kernel E2 plus exact rescore with
``kernel="int4"``), BM25 top-c, fusion, copy back. The JAX program scanned
the sub-batches inside one jitted dispatch; here a Python loop runs them,
since PyTorch dispatches eagerly.

Filtered search (``filter_mask``) is not ported yet (ROADMAP.md) and raises
``NotImplementedError``.

On the card the three serving stages can overlap (``serving.py``):
``prepare`` stages its operands from pinned host memory on the calling
thread's current stream and records an event, which the step waits for on
its own stream; ``copy_back`` queues the result's copy into pinned host
buffers right after the step, and ``finalize_prepared`` waits for that
copy alone. On the CPU each stage runs to its end in turn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from openintel_tpu_torch import convert, default_device
from openintel_tpu_torch.index.build import build_postings_index
from openintel_tpu_torch.index.schema import BM25Config, DenseIndex, PostingsIndex
from openintel_tpu_torch.models.embedding import HashingEmbedder
from openintel_tpu_torch.ops.bm25 import (
    bm25_topk_device,
    build_query_plan,
    encode_query,
)
from openintel_tpu_torch.ops.dense import dense_topk_xla
from openintel_tpu_torch.ops.dense_topk import (
    auto_i8_group,
    dense_topk_fast,
    dense_topk_fast_i4,
    dense_topk_fast_i8_grouped,
    dense_topk_pallas,
    exact_rescore,
    quantize_int8,
)
from openintel_tpu_torch.ops.fusion import (
    BLEND_ALPHA,
    RRF_K,
    rrf_fuse_device,
    zblend_fuse_device,
)

KERNELS = ("xla", "pallas", "fast", "int8", "int4")
_QUANTIZED = ("int8", "int4")  # int8 queries, f32 rescore queries


def _no_filters(filter_mask, filter_group) -> None:
    if filter_mask is not None or filter_group is not None:
        raise NotImplementedError(
            "filtered search is not ported yet (ROADMAP.md: filtered "
            "search, mask_compact_ranked* and the fused filtered program)"
        )


@dataclass
class SearchResult:
    """Ranked results for a batch of queries; -1 ids pad short rankings."""

    ids: np.ndarray  # (B, k) int32
    scores: np.ndarray  # (B, k) float32


@dataclass
class PreparedBatch:
    """Device-staged operands of one hybrid run
    (``HybridRetriever.prepare`` -> ``run_prepared``)."""

    queries: torch.Tensor  # (nb, db, D) rescore/emb dtype
    queries_i8: torch.Tensor  # (nb, db, D) int8 (a stub unless int8/int4)
    plan_doc_ids: torch.Tensor  # (nb, db, W) int32
    plan_weights: torch.Tensor  # (nb, db, W) f32
    n_queries: int  # true query count (before sub-batch padding)
    k: int
    candidates_per_arm: int
    presorted: bool
    max_run: int
    # on the card: recorded on the staging stream after the operands' copies
    ready: Optional[torch.cuda.Event] = None


@dataclass
class HostCopy:
    """A step's (vals, ids) on their way to the host
    (``HybridRetriever.copy_back``): on the card pinned buffers that hold
    the result once ``done`` has completed; on the CPU the tensors
    themselves (``done`` None)."""

    vals: torch.Tensor  # (nb, db, k) f32
    ids: torch.Tensor  # (nb, db, k) int32
    done: Optional[torch.cuda.Event] = None


def _staged(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``: on the card from pinned memory, queued on the
    current stream without waiting for it."""
    if dev.type != "cuda":
        return x.to(dev)
    return x.pin_memory().to(dev, non_blocking=True)


AUTO_PRUNE_DOCS = 100_000  # corpora above this default to pruned plans


def dense_arm_topk(
    kernel: str,
    emb_op: torch.Tensor,
    q: torch.Tensor,
    k: int,
    *,
    n_docs: int,
    block_c: int = 8192,
    candidates: Optional[int] = None,  # int8 candidate count (default 2k>=32)
    rescore_op: Optional[torch.Tensor] = None,  # (N, D) rows, int8/int4
    q8: Optional[torch.Tensor] = None,  # (B, D) int8 queries, int8/int4
    plain: bool = False,  # run each kernel's plain twin (verification)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense-arm dispatch shared by ``DenseRetriever`` and the hybrid
    step, so kernel and block_c handling cannot drift between them.

    ``emb_op`` is the candidate corpus, its feature axis zero-padded to a
    multiple of 16 at load (``convert``); the kernels' wrappers pad ``q``
    and ``q8`` to its width per call. The rescore takes ``rescore_op`` (the
    stored rows) and ``q`` at the true D."""
    if kernel == "int8":
        c = candidates if candidates is not None else min(max(2 * k, 32), n_docs)
        _, cids = dense_topk_fast_i8_grouped(
            emb_op, q8, k=c, block_c=block_c, n_docs=n_docs,
            group=auto_i8_group(n_docs, c), plain=plain,
        )
        return exact_rescore(rescore_op, q, cids, k)
    if kernel == "int4":
        # the coarser int4 quantiser needs a wider fetch than the pool
        # width before the rescore recovers the exact order (the
        # reference's max(4c, 256); `candidates` is the pool width)
        cw = min(max(4 * (candidates or k), 256), n_docs)
        _, cids = dense_topk_fast_i4(
            emb_op, q8, k=cw, block_c=min(block_c, 4096), n_docs=n_docs,
            plain=plain,
        )
        return exact_rescore(rescore_op, q, cids, k)
    if kernel == "fast":  # no rescore: the quantised scores go to fusion
        return dense_topk_fast(
            emb_op, q, k=k, block_c=block_c, n_docs=n_docs, plain=plain
        )
    if kernel == "pallas":
        return dense_topk_pallas(emb_op, q, k=k, plain=plain)
    if kernel == "xla":
        return dense_topk_xla(emb_op, q, k)
    raise ValueError(f"unknown dense kernel {kernel!r}")


def auto_prune_m(n_docs: int, k: int) -> Optional[int]:
    """Default impact-pruning budget for serving: M = max(128, k) above
    AUTO_PRUNE_DOCS (keeps pruned top-k exact, as the reference's
    ``auto_prune_m`` argues), none below."""
    return max(128, k) if n_docs > AUTO_PRUNE_DOCS else None


def _as_device(device) -> torch.device:
    return torch.device(device) if device is not None else default_device()


class BM25Retriever:
    """Lexical retrieval over the CSR postings index (host plan, device
    reduction)."""

    def __init__(self, index: PostingsIndex, *, device=None):
        self.index = index
        self.device = _as_device(device)

    @classmethod
    def build(
        cls, texts: Sequence[str], *, config: BM25Config = BM25Config(),
        device=None,
    ):
        return cls(build_postings_index(texts, config=config), device=device)

    def search(
        self,
        queries: Sequence[str],
        k: int = 10,
        *,
        filter_mask=None,
        filter_group=None,
    ) -> SearchResult:
        _no_filters(filter_mask, filter_group)
        term_ids = [encode_query(self.index, q) for q in queries]
        plan = build_query_plan(
            self.index,
            term_ids,
            max_postings_per_term=auto_prune_m(self.index.n_docs, k),
            multi_budget=max(256, k),
        )
        vals, ids = bm25_topk_device(
            torch.from_numpy(plan.doc_ids).to(self.device),
            torch.from_numpy(plan.weights).to(self.device),
            plan.n_docs,
            min(k, self.index.n_docs),
            presorted=plan.presorted,
            max_run=plan.max_terms,
        )
        return SearchResult(ids=ids.cpu().numpy(), scores=vals.cpu().numpy())


class DenseRetriever:
    """Brute-force cosine retrieval over the dense index: kernel A plus
    exact rescore (``int8``), kernel B (``pallas``), the blocked exact
    product (``xla``), or, opt-in, kernel D (``fast``) or kernel E2 plus
    exact rescore (``int4``)."""

    def __init__(
        self,
        index: DenseIndex,
        embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        *,
        use_pallas: Optional[bool] = None,
        kernel: Optional[str] = None,  # one of KERNELS | None=auto
        device=None,
    ):
        self.index = index
        self.embedder = embedder or HashingEmbedder(dim=index.dim)
        self.device = _as_device(device)
        if kernel is None:
            if use_pallas is False:
                kernel = "xla"
            elif use_pallas is True:
                kernel = "pallas"
            elif self.device.type == "cpu":
                kernel = "xla"
            elif index.n_docs >= AUTO_PRUNE_DOCS:
                # serving scale: int8 candidates + exact rescore
                kernel = "int8"
            else:
                # small corpora: the int8 cells hold at most 256 candidates
                # per 16,384-doc super, so few-super indexes serve the exact
                # fused kernel instead
                kernel = "pallas"
        if kernel not in KERNELS:
            raise ValueError(f"unknown dense kernel {kernel!r}")
        self.kernel = kernel
        rows = convert.stored_rows(index, self.device)
        # the candidate corpora are made from the STORED rows (bf16-rounded
        # where the store is bf16); for int8/int4 the rows themselves serve
        # the exact rescore
        self._rescore_emb = rows if kernel in _QUANTIZED else None
        if kernel == "int8":
            self._emb_device = convert.int8_corpus(rows)
        elif kernel == "int4":
            self._emb_device = convert.int4_corpus(rows)
        elif kernel == "fast":
            self._emb_device = convert.fast_corpus(rows)
        elif kernel == "pallas":
            self._emb_device = convert.fused_corpus(rows)
        else:
            self._emb_device = rows

    @classmethod
    def build(
        cls,
        texts: Sequence[str],
        *,
        embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        dim: int = 384,
        dtype: torch.dtype = torch.float32,
        kernel: Optional[str] = None,
        device=None,
    ):
        embedder = embedder or HashingEmbedder(dim=dim)
        index = DenseIndex.from_embeddings(embedder(list(texts)), dtype=dtype)
        return cls(index, embedder, kernel=kernel, device=device)

    @property
    def query_dtype(self) -> torch.dtype:
        """int8/int4: f32 queries into the exact rescore (rounding them to
        the stored dtype shifts near-ties); otherwise the stored dtype."""
        if self.kernel in _QUANTIZED:
            return torch.float32
        return self._emb_device.dtype

    def search_embeddings(
        self,
        query_emb: np.ndarray,
        k: int = 10,
        *,
        filter_mask=None,
        filter_group=None,
    ) -> SearchResult:
        _no_filters(filter_mask, filter_group)
        q32 = torch.from_numpy(np.asarray(query_emb, np.float32))
        q = q32.to(device=self.device, dtype=self.query_dtype)
        k = min(k, self.index.n_docs)
        vals, ids = dense_arm_topk(
            self.kernel,
            self._emb_device,
            q,
            k,
            n_docs=self.index.n_docs,
            rescore_op=self._rescore_emb,
            q8=(
                quantize_int8(q32).to(self.device)
                if self.kernel in _QUANTIZED
                else None
            ),
        )
        return SearchResult(ids=ids.cpu().numpy(), scores=vals.cpu().numpy())

    def search(
        self,
        queries: Sequence[str],
        k: int = 10,
        *,
        filter_mask=None,
        filter_group=None,
    ) -> SearchResult:
        return self.search_embeddings(
            self.embedder(list(queries)), k, filter_mask=filter_mask,
            filter_group=filter_group,
        )


class HybridRetriever:
    """BM25 + dense cosine fused with a z-normalised score blend (alpha
    0.7, the reference's measured default) or RRF (``fusion="rrf"``).

    ``search`` chunks the query list into ``device_batch``-query
    sub-batches and runs the hybrid step on each: BM25 segmented-sum
    reduction, dense candidates [+ exact rescore], fusion."""

    def __init__(
        self,
        postings: PostingsIndex,
        dense: DenseIndex,
        embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        *,
        rrf_k: float = RRF_K,
        fusion: str = "zblend",  # "zblend" | "rrf"
        blend_alpha: float = BLEND_ALPHA,
        use_pallas: Optional[bool] = None,
        kernel: Optional[str] = None,  # one of KERNELS | None=auto
        device_batch: int = 256,
        device=None,
    ):
        if fusion not in ("rrf", "zblend"):
            raise ValueError(f"unknown fusion {fusion!r}")
        self.device = _as_device(device)
        self.bm25 = BM25Retriever(postings, device=self.device)
        self.dense = DenseRetriever(
            dense, embedder, use_pallas=use_pallas, kernel=kernel,
            device=self.device,
        )
        self.rrf_k = rrf_k
        self.fusion = fusion
        self.blend_alpha = blend_alpha
        self.device_batch = max(1, device_batch)

    @classmethod
    def build(
        cls,
        texts: Sequence[str],
        *,
        embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        config: BM25Config = BM25Config(),
        dim: int = 384,
        dtype: torch.dtype = torch.float32,
        rrf_k: float = RRF_K,
        fusion: str = "zblend",
        blend_alpha: float = BLEND_ALPHA,
        use_pallas: Optional[bool] = None,
        kernel: Optional[str] = None,
        device_batch: int = 256,
        device=None,
    ):
        embedder = embedder or HashingEmbedder(dim=dim)
        postings = build_postings_index(texts, config=config)
        dense = DenseIndex.from_embeddings(embedder(list(texts)), dtype=dtype)
        return cls(
            postings, dense, embedder, rrf_k=rrf_k, fusion=fusion,
            blend_alpha=blend_alpha, use_pallas=use_pallas,
            kernel=kernel, device_batch=device_batch, device=device,
        )

    @property
    def n_docs(self) -> int:
        return self.bm25.index.n_docs

    @property
    def kernel(self) -> str:
        """The dense-arm kernel this instance serves."""
        return self.dense.kernel

    def _fuse_arms(self, b_vals, b_ids, d_vals, d_ids, k):
        if self.fusion == "zblend":
            return zblend_fuse_device(
                b_vals, b_ids, d_vals, d_ids, k, self.blend_alpha
            )
        return rrf_fuse_device(b_ids, d_ids, k, self.rrf_k)

    def _dense_block_c(self, db: int) -> int:
        # the reference's step width (8192 at production batch, 4096
        # below): the int8 fold's tie rules make it part of the result
        # (kernels D and E only validate it)
        return 8192 if db >= 128 else 4096

    def search(
        self,
        queries: Sequence[str],
        k: int = 10,
        *,
        query_embeddings: Optional[np.ndarray] = None,
        candidates_per_arm: Optional[int] = None,
        filter_mask=None,
        filter_group=None,
    ) -> SearchResult:
        _no_filters(filter_mask, filter_group)
        b = len(queries)
        if b == 0:
            return SearchResult(
                ids=np.zeros((0, k), np.int32),
                scores=np.zeros((0, k), np.float32),
            )
        term_ids = [encode_query(self.bm25.index, q) for q in queries]
        if query_embeddings is None:
            query_embeddings = self.dense.embedder(list(queries))
        return self.search_prepared(
            term_ids, query_embeddings, k=k,
            candidates_per_arm=candidates_per_arm,
        )

    def prepare(
        self,
        term_ids: Sequence[Sequence[int]],
        query_embeddings: np.ndarray,
        k: int = 10,
        *,
        candidates_per_arm: Optional[int] = None,
        device_batch: Optional[int] = None,
        filter_mask=None,
        filter_group=None,
    ) -> PreparedBatch:
        """Host-side preparation: build the (pruned, presorted) BM25 plan
        over all queries, chunk everything into device sub-batches and
        stage the operands on the device. ``run_prepared`` then runs the
        hybrid step; ``search`` == ``run_prepared(prepare(...))``."""
        _no_filters(filter_mask, filter_group)
        index = self.bm25.index
        n_docs = index.n_docs
        b = len(term_ids)
        c = min(candidates_per_arm or k, n_docs)
        k = min(k, n_docs)
        dev = self.device
        if b == 0:
            dim = self.dense.index.dim
            return PreparedBatch(
                queries=torch.zeros((0, 1, dim), device=dev),
                queries_i8=torch.zeros((0, 1, 1), dtype=torch.int8, device=dev),
                plan_doc_ids=torch.zeros((0, 1, 1), dtype=torch.int32, device=dev),
                plan_weights=torch.zeros((0, 1, 1), device=dev),
                n_queries=0, k=k, candidates_per_arm=c,
                presorted=True, max_run=1,
            )

        db = min(device_batch or self.device_batch, b)
        pad = (-b) % db
        plan = build_query_plan(
            index,
            list(term_ids) + [[]] * pad,
            max_postings_per_term=auto_prune_m(n_docs, c),
            multi_budget=max(256, c),
        )
        nb = (b + pad) // db
        w = plan.doc_ids.shape[1]
        q = np.asarray(query_embeddings, np.float32)
        if pad:
            q = np.concatenate(
                [q, np.zeros((pad, q.shape[1]), np.float32)], axis=0
            )
        q32 = torch.from_numpy(q.reshape(nb, db, q.shape[1]))
        if self.dense.kernel in _QUANTIZED:
            qbs8 = _staged(quantize_int8(q32), dev)
        else:
            qbs8 = torch.zeros((nb, db, 1), dtype=torch.int8, device=dev)
        prep = PreparedBatch(
            queries=_staged(q32, dev).to(self.dense.query_dtype),
            queries_i8=qbs8,
            plan_doc_ids=_staged(torch.from_numpy(plan.doc_ids.reshape(nb, db, w)), dev),
            plan_weights=_staged(torch.from_numpy(plan.weights.reshape(nb, db, w)), dev),
            n_queries=b,
            k=k,
            candidates_per_arm=c,
            presorted=plan.presorted,
            max_run=plan.max_terms,
        )
        if dev.type == "cuda":
            prep.ready = torch.cuda.Event()
            prep.ready.record(torch.cuda.current_stream(dev))
        return prep

    def rebatch(self, prep: PreparedBatch, device_batch: int) -> PreparedBatch:
        """Re-chunk a PreparedBatch to another sub-batch size without
        rebuilding the query plan; the padded query count must divide
        evenly."""
        nb, db = prep.queries.shape[:2]
        total = nb * db
        if total % device_batch:
            raise ValueError(f"{total} queries do not split into {device_batch}")

        def chunk(a):
            return a.reshape((total // device_batch, device_batch) + a.shape[2:])

        return PreparedBatch(
            queries=chunk(prep.queries),
            queries_i8=chunk(prep.queries_i8),
            plan_doc_ids=chunk(prep.plan_doc_ids),
            plan_weights=chunk(prep.plan_weights),
            n_queries=prep.n_queries,
            k=prep.k,
            candidates_per_arm=prep.candidates_per_arm,
            presorted=prep.presorted,
            max_run=prep.max_run,
            ready=prep.ready,
        )

    def _await_staging(self, prep: PreparedBatch) -> None:
        """On the card: the current stream waits for ``prep``'s staging
        copies (queued on another thread's stream, maybe), and the caching
        allocator learns that the staged blocks are read here too."""
        if prep.ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(prep.ready)
        for t in (prep.queries, prep.queries_i8, prep.plan_doc_ids, prep.plan_weights):
            t.record_stream(stream)

    def run_prepared_device(
        self, prep: PreparedBatch, *, plain: bool = False
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The hybrid step over every sub-batch in ``prep``. Returns device
        tensors ((nb, db, k) vals, ids), not yet synchronised;
        ``finalize_prepared`` copies them back. ``plain`` runs each
        kernel's plain twin instead (to check the kernels against)."""
        nb, db = prep.queries.shape[:2]
        k, c = prep.k, prep.candidates_per_arm
        dense = self.dense
        self._await_staging(prep)
        out_vals, out_ids = [], []
        for i in range(nb):
            d_vals, d_ids = dense_arm_topk(
                dense.kernel, dense._emb_device, prep.queries[i], c,
                n_docs=self.n_docs, block_c=self._dense_block_c(db),
                candidates=c, rescore_op=dense._rescore_emb,
                q8=prep.queries_i8[i], plain=plain,
            )
            b_vals, b_ids = bm25_topk_device(
                prep.plan_doc_ids[i], prep.plan_weights[i], self.n_docs, c,
                presorted=prep.presorted, max_run=prep.max_run,
            )
            vals, ids = self._fuse_arms(b_vals, b_ids, d_vals, d_ids, k)
            out_vals.append(vals)
            out_ids.append(ids)
        if not out_vals:
            empty = (0, db, k)
            return (
                torch.zeros(empty, device=self.device),
                torch.zeros(empty, dtype=torch.int32, device=self.device),
            )
        return torch.stack(out_vals), torch.stack(out_ids)

    def run_prepared(self, prep: PreparedBatch) -> SearchResult:
        """``run_prepared_device`` + copy-back of the (b, k) result."""
        if prep.n_queries == 0:
            return SearchResult(
                ids=np.zeros((0, prep.k), np.int32),
                scores=np.zeros((0, prep.k), np.float32),
            )
        return self.finalize_prepared(prep, self.run_prepared_device(prep))

    def copy_back(self, device_out) -> HostCopy:
        """Queue the copy of a ``run_prepared_device`` result to the host.
        On the card: into pinned buffers on the current stream, right
        behind the step, with an event after it, so that a later wait
        covers this copy and not work queued after it (the next wave's
        step); on the CPU the tensors as they are."""
        vals, ids = device_out
        if vals.device.type != "cuda":
            return HostCopy(vals.cpu(), ids.cpu())
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (vals, ids)]
        for dst, src in zip(host, (vals, ids)):
            dst.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(vals.device))
        return HostCopy(host[0], host[1], done)

    def finalize_prepared(self, prep: PreparedBatch, device_out) -> SearchResult:
        """The (b, k) result of ``run_prepared_device`` on the host:
        ``device_out`` is its (vals, ids), whose copy is queued here, or
        the ``HostCopy`` of an earlier ``copy_back``, whose copy alone is
        waited for."""
        nb, db = prep.queries.shape[:2]
        b, k = prep.n_queries, prep.k
        copy = device_out if isinstance(device_out, HostCopy) else self.copy_back(device_out)
        if copy.done is not None:
            copy.done.synchronize()
        # copied out of the pinned buffers, which go back to their pool
        return SearchResult(
            ids=np.array(copy.ids.numpy().reshape(nb * db, k)[:b]),
            scores=np.array(copy.vals.numpy().reshape(nb * db, k)[:b]),
        )

    def search_prepared(
        self,
        term_ids: Sequence[Sequence[int]],
        query_embeddings: np.ndarray,
        k: int = 10,
        *,
        candidates_per_arm: Optional[int] = None,
        filter_mask=None,
        filter_group=None,
    ) -> SearchResult:
        """The hybrid search on pre-encoded queries (term ids +
        embeddings)."""
        return self.run_prepared(
            self.prepare(
                term_ids, query_embeddings, k=k,
                candidates_per_arm=candidates_per_arm,
                filter_mask=filter_mask, filter_group=filter_group,
            )
        )
