"""Retriever families of the port: BM25, dense cosine, and the hybrid.

Port of the reference's ``models.retrievers``. The retrievers own the
index tensors on one device, encode queries and run the hybrid step per
query sub-batch: host BM25 plan, dense candidates (kernel A plus exact
rescore at 100k docs and more, kernel B below that; opt-in, kernel D with
``kernel="fast"`` and kernel E2 plus exact rescore with ``kernel="int4"``),
BM25 top-c, fusion, copy back. The JAX program scanned the sub-batches
inside one jitted dispatch; here a Python loop runs them, since PyTorch
dispatches eagerly.

Filtered search (``filter_mask``: bool ``(n_docs,)``, or ``(G, n_docs)``
with ``filter_group``, one mask row per query) is exact at any
selectivity, as in the reference: the BM25 arm filters in its plan, the
dense arm over-fetches ``filtered_fetch_width`` candidates and
rank-compacts the unmasked ones, and the queries whose pool under-fills
go through an exact masked scan (``HybridRetriever._filtered_fallback``).
The step's kernels are the unfiltered step's, at the wider fetch.

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
    QueryPlan,
    bm25_topk_device,
    build_query_plan,
    encode_query,
)
from openintel_tpu_torch.ops.dense import (
    dense_topk_xla,
    dense_topk_xla_masked,
)
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
    mask_compact_ranked,
    mask_compact_ranked_vals,
    rrf_fuse_device,
    zblend_fuse_device,
)

KERNELS = ("xla", "pallas", "fast", "int8", "int4")
_QUANTIZED = ("int8", "int4")  # int8 queries, f32 rescore queries


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
    # filtered search (None/0 = unfiltered)
    filter_mask: Optional[torch.Tensor] = None  # (G, n_docs) bool on the device
    filter_group: Optional[torch.Tensor] = None  # (nb, db) int32 mask row per query
    filter_group_host: Optional[np.ndarray] = None  # the same, on the host
    group_unmasked: Optional[np.ndarray] = None  # (G,) unmasked docs per mask row
    n_unmasked: int = 0  # the fewest unmasked docs over the batch's groups
    c_fetch: int = 0  # the dense arm's over-fetch width


@dataclass
class HostCopy:
    """A step's (vals, ids) and, for a filtered step, its dense survivor
    counts on their way to the host (``HybridRetriever.copy_back``): on
    the card pinned buffers that hold the result once ``done`` has
    completed; on the CPU the tensors themselves (``done`` None)."""

    vals: torch.Tensor  # (nb, db, k) f32
    ids: torch.Tensor  # (nb, db, k) int32
    done: Optional[torch.cuda.Event] = None
    surv: Optional[torch.Tensor] = None  # (nb, db) int32, filtered steps


def _staged(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``: on the card from pinned memory, queued on the
    current stream without waiting for it."""
    if dev.type != "cuda":
        return x.to(dev)
    return x.pin_memory().to(dev, non_blocking=True)


AUTO_PRUNE_DOCS = 100_000  # corpora above this default to pruned plans

# Filtered search: the cap on the dense arm's over-fetch width, the widest
# every kernel takes (kernel B's k <= 1,024; the candidate kernels clamp
# to their capacity and pad). Below ~c / 1,024 selectivity the pool
# starves and the exact masked fallback takes over, the right algorithm
# at that selectivity anyway.
FILTER_FETCH_CAP = 1024


def filtered_fetch_width(c: int, n_docs: int, n_unmasked: int) -> int:
    """Dense-arm over-fetch width for a filtered search: enough unfiltered
    candidates that, at the mask's selectivity, >= c survivors are
    expected with a 2x margin. Bucketed to powers of two from 64; capped
    at FILTER_FETCH_CAP and n_docs."""
    if n_unmasked <= 0:
        return min(max(c, 1), n_docs)
    sel = n_unmasked / n_docs
    want = max(2 * c, int(np.ceil(c / sel)))
    width = 64
    while width < want and width < FILTER_FETCH_CAP:
        width *= 2
    return min(max(width, c), FILTER_FETCH_CAP, n_docs)


def _as_doc_mask(filter_mask, n_docs: int) -> np.ndarray:
    """Validate/normalise a user filter into a bool (n_docs,) numpy mask."""
    mask = np.asarray(filter_mask)
    if mask.dtype != np.bool_:
        raise TypeError(f"filter_mask must be bool, got {mask.dtype}")
    if mask.shape != (n_docs,):
        raise ValueError(f"filter_mask shape {mask.shape} != ({n_docs},)")
    return mask


def _as_group_masks(
    filter_mask, filter_group, n_docs: int, b: int
) -> tuple[np.ndarray, np.ndarray]:
    """Normalise per-batch or per-query filters into ((G, n_docs) bool
    masks, (b,) int32 mask row per query): a (n_docs,) mask without
    ``filter_group`` is one group for all queries; (G, n_docs) masks take
    ``filter_group``, b ints in [0, G) (required when G > 1)."""
    masks = np.asarray(filter_mask)
    if masks.dtype != np.bool_:
        raise TypeError(f"filter_mask must be bool, got {masks.dtype}")
    if masks.ndim == 1:
        if filter_group is not None:
            raise ValueError(
                "filter_group requires a (G, n_docs) filter_mask; got 1-D"
            )
        if masks.shape != (n_docs,):
            raise ValueError(
                f"filter_mask shape {masks.shape} != ({n_docs},)"
            )
        return masks[None, :], np.zeros(b, np.int32)
    if masks.ndim != 2 or masks.shape[1] != n_docs or masks.shape[0] < 1:
        raise ValueError(
            f"filter_mask shape {masks.shape} != (G >= 1, {n_docs})"
        )
    if filter_group is None:
        if masks.shape[0] != 1:
            raise ValueError(
                "filter_group (one int per query) is required when "
                f"filter_mask has {masks.shape[0]} > 1 rows"
            )
        return masks, np.zeros(b, np.int32)
    raw = np.asarray(list(filter_group))
    if not np.issubdtype(raw.dtype, np.integer):
        # a truncating cast would apply the wrong tenant's mask
        raise TypeError(
            f"filter_group must be integers, got dtype {raw.dtype}"
        )
    groups = raw.astype(np.int32)
    if groups.shape != (b,):
        raise ValueError(
            f"filter_group length {groups.shape} != ({b},) queries"
        )
    if groups.size and (groups.min() < 0 or groups.max() >= masks.shape[0]):
        raise ValueError(
            f"filter_group out of range [0, {masks.shape[0]}): "
            f"[{groups.min()}, {groups.max()}]"
        )
    if masks.shape[0] * n_docs >= 2**31:
        # the reference gathers mask_flat[g * n_docs + id] in int32; the
        # port's int64 gather would not overflow, but both refuse alike
        raise ValueError(
            f"{masks.shape[0]} mask rows x {n_docs} docs overflows the "
            "int32 flat mask index; use fewer distinct filter groups"
        )
    return masks, groups


def make_filter_mask(
    n_docs: int,
    *,
    include_ids: Optional[Sequence[int]] = None,
    exclude_ids: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Build a (n_docs,) bool doc mask from id lists: start from all docs
    (or only ``include_ids`` when given), then drop ``exclude_ids``.
    Out-of-range, non-integer or non-list ids raise: a silent drop or a
    truncating cast (3.7 -> doc 3) would make a filter look applied when
    it was not."""

    def _ids(name, value):
        if value is None:
            return None
        try:
            arr = np.asarray(list(value))
        except TypeError:
            raise ValueError(
                f"{name} must be a list of integers, got "
                f"{type(value).__name__}"
            ) from None
        if arr.size and not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(
                f"{name} must be integers, got dtype {arr.dtype}"
            )
        arr = arr.astype(np.int64)
        if arr.size and (arr.min() < 0 or arr.max() >= n_docs):
            raise ValueError(
                f"{name} out of range [0, {n_docs}): "
                f"[{arr.min()}, {arr.max()}]"
            )
        return arr

    inc = _ids("include_ids", include_ids)
    exc = _ids("exclude_ids", exclude_ids)
    if inc is not None:
        mask = np.zeros(n_docs, dtype=bool)
        mask[inc] = True
    else:
        mask = np.ones(n_docs, dtype=bool)
    if exc is not None:
        mask[exc] = False
    return mask


def run_per_group(
    groups: np.ndarray, k: int, fn
) -> tuple[np.ndarray, np.ndarray]:
    """Run ``fn(g, rows) -> ((len(rows), k) vals, (len(rows), k) ids)``
    once per distinct mask group and scatter the results back into row
    order (grouped dense search, the starvation fallback)."""
    out_vals = np.empty((groups.shape[0], k), np.float32)
    out_ids = np.empty((groups.shape[0], k), np.int32)
    for g in np.unique(groups):
        rows = np.flatnonzero(groups == g)
        vals, ids = fn(int(g), rows)
        out_vals[rows] = vals
        out_ids[rows] = ids
    return out_vals, out_ids


def grouped_query_plan(
    index,
    term_ids: Sequence[Sequence[int]],
    masks: np.ndarray,  # (G, n_docs) bool
    groups: np.ndarray,  # (B,) int32 mask row per query
    *,
    max_postings_per_term: Optional[int] = None,
    multi_budget: int = 256,
) -> QueryPlan:
    """Mask-aware BM25 plan for a batch whose queries carry per-query
    filters: one ``build_query_plan`` per distinct mask row over that
    group's queries (each exact on its own filtered corpus), reassembled
    into one (B, W) plan at the widest group's width. All-True rows build
    the unfiltered plan; sentinel padding (doc id = n_docs) keeps rows
    presorted."""
    b = len(term_ids)
    per_group = []
    presorted = True
    max_terms = 1
    width = 1
    for g in np.unique(groups):
        rows = np.flatnonzero(groups == g)
        plan = build_query_plan(
            index,
            [term_ids[i] for i in rows],
            max_postings_per_term=max_postings_per_term,
            multi_budget=multi_budget,
            doc_mask=masks[g] if not masks[g].all() else None,
        )
        per_group.append((rows, plan))
        presorted = presorted and plan.presorted
        max_terms = max(max_terms, plan.max_terms)
        width = max(width, plan.doc_ids.shape[1])
    out_ids = np.full((b, width), index.n_docs, np.int32)
    out_w = np.zeros((b, width), np.float32)
    for rows, plan in per_group:
        w = plan.doc_ids.shape[1]
        out_ids[rows, :w] = plan.doc_ids
        out_w[rows, :w] = plan.weights
    return QueryPlan(
        doc_ids=out_ids,
        weights=out_w,
        n_docs=index.n_docs,
        presorted=presorted,
        max_terms=max_terms,
    )


def starved_rows(prep: PreparedBatch, surv: np.ndarray) -> np.ndarray:
    """The real rows of a filtered batch whose dense pool kept fewer than
    min(c, their group's unmasked docs) survivors (``surv``, (nb, db)):
    the rows the exact fallback serves."""
    b = prep.n_queries
    groups = prep.filter_group_host.reshape(-1)[:b]
    need = np.minimum(prep.candidates_per_arm, prep.group_unmasked[groups])
    return np.flatnonzero(surv.reshape(-1)[:b] < need)


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
        """``filter_mask`` (bool (n_docs,), or (G, n_docs) with
        ``filter_group``, one mask row per query) restricts results to
        unmasked docs, exactly: the plan is mask-aware, so masked docs
        never reach the device. Scores keep the full corpus's idf."""
        term_ids = [encode_query(self.index, q) for q in queries]
        prune_m = auto_prune_m(self.index.n_docs, k)
        if filter_mask is not None:
            masks, groups = _as_group_masks(
                filter_mask, filter_group, self.index.n_docs, len(queries)
            )
            plan = grouped_query_plan(
                self.index, term_ids, masks, groups,
                max_postings_per_term=prune_m, multi_budget=max(256, k),
            )
        else:
            if filter_group is not None:
                raise ValueError("filter_group requires filter_mask")
            plan = build_query_plan(
                self.index,
                term_ids,
                max_postings_per_term=prune_m,
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

    def _masked_topk(self, q: torch.Tensor, mask: torch.Tensor, k: int):
        """Exact masked dense top-k over the resident copy of the corpus:
        the stored rows for the quantised arms (the rescore's scores),
        kernel D's padded corpus for ``fast``, the arm's rows otherwise;
        each over its first ``n_docs`` rows at the queries' width. The
        filtered fallback's dense arm, and ``DenseRetriever``'s whole
        filtered search."""
        rows = self._rescore_emb if self.kernel in _QUANTIZED else self._emb_device
        return dense_topk_xla_masked(rows, q, mask, k, n_docs=self.index.n_docs)

    def search_embeddings(
        self,
        query_emb: np.ndarray,
        k: int = 10,
        *,
        filter_mask=None,
        filter_group=None,
    ) -> SearchResult:
        """``filter_mask`` / ``filter_group`` as in
        ``BM25Retriever.search``: the exact masked scan, one per distinct
        mask row."""
        q32 = torch.from_numpy(np.asarray(query_emb, np.float32))
        q = q32.to(device=self.device, dtype=self.query_dtype)
        if filter_mask is not None:
            masks, groups = _as_group_masks(
                filter_mask, filter_group, self.index.n_docs, q.shape[0]
            )

            def arm(g, rows):
                sel = torch.from_numpy(rows).to(self.device)
                mask = torch.from_numpy(masks[g]).to(self.device)
                vals, ids = self._masked_topk(q[sel], mask, k)
                return vals.cpu().numpy(), ids.cpu().numpy()

            if masks.shape[0] == 1:
                vals, ids = arm(0, np.arange(q.shape[0]))
                return SearchResult(ids=ids, scores=vals)
            vals, ids = run_per_group(groups, min(k, self.index.n_docs), arm)
            return SearchResult(ids=ids, scores=vals)
        if filter_group is not None:
            raise ValueError("filter_group requires filter_mask")
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
        """``filter_mask`` (bool (n_docs,); see :func:`make_filter_mask`)
        restricts results to unmasked docs, exactly: each arm ranks the
        filtered corpus under the full corpus's statistics, then fuses.
        Per-query filters: (G, n_docs) masks and ``filter_group``, one
        mask row per query."""
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
            filter_mask=filter_mask, filter_group=filter_group,
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
        hybrid step; ``search`` == ``run_prepared(prepare(...))``.
        ``filter_mask`` stages a filtered batch: a mask-aware plan, the
        (G, n_docs) masks and a mask row per query on the device, and the
        over-fetch width sized by the batch's most selective group."""
        index = self.bm25.index
        n_docs = index.n_docs
        b = len(term_ids)
        c = min(candidates_per_arm or k, n_docs)
        k = min(k, n_docs)
        dev = self.device
        doc_masks = groups = None
        if filter_mask is not None:
            doc_masks, groups = _as_group_masks(filter_mask, filter_group, n_docs, b)
        elif filter_group is not None:
            raise ValueError("filter_group requires filter_mask")
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
        term_ids = list(term_ids) + [[]] * pad
        if doc_masks is not None:
            # padding rows take group 0: their plans are empty and their
            # results dropped, so they need only a valid mask row
            groups = np.concatenate([groups, np.zeros(pad, np.int32)])
            plan = grouped_query_plan(
                index, term_ids, doc_masks, groups,
                max_postings_per_term=auto_prune_m(n_docs, c),
                multi_budget=max(256, c),
            )
        else:
            plan = build_query_plan(
                index,
                term_ids,
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
        if doc_masks is not None:
            prep.filter_mask = _staged(torch.from_numpy(doc_masks), dev)
            prep.filter_group_host = groups.reshape(nb, db)
            prep.filter_group = _staged(torch.from_numpy(prep.filter_group_host), dev)
            prep.group_unmasked = doc_masks.sum(axis=1).astype(np.int64)
            # sized for the most selective group among the real rows
            prep.n_unmasked = int(prep.group_unmasked[np.unique(groups[:b])].min())
            prep.c_fetch = filtered_fetch_width(c, n_docs, prep.n_unmasked)
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
            filter_mask=prep.filter_mask,
            filter_group=(
                chunk(prep.filter_group) if prep.filter_group is not None else None
            ),
            filter_group_host=(
                chunk(prep.filter_group_host)
                if prep.filter_group_host is not None
                else None
            ),
            group_unmasked=prep.group_unmasked,
            n_unmasked=prep.n_unmasked,
            c_fetch=prep.c_fetch,
        )

    def _await_staging(self, prep: PreparedBatch) -> None:
        """On the card: the current stream waits for ``prep``'s staging
        copies (queued on another thread's stream, maybe), and the caching
        allocator learns that the staged blocks are read here too."""
        if prep.ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(prep.ready)
        staged = (prep.queries, prep.queries_i8, prep.plan_doc_ids, prep.plan_weights)
        if prep.filter_mask is not None:
            staged += (prep.filter_mask, prep.filter_group)
        for t in staged:
            t.record_stream(stream)

    def _compact_pool(self, prep: PreparedBatch, i: int, d_vals, d_ids):
        """Sub-batch ``i``'s over-fetched dense pool cut to its unmasked
        candidates, in rank order: (vals, ids) at c and the survivor
        counts. Each query gathers its own mask row from the flattened
        (G, n_docs) masks at g * n_docs + id."""
        c, n_docs = prep.candidates_per_arm, self.n_docs
        flat = prep.filter_group[i][:, None].long() * n_docs + d_ids.clamp(min=0).long()
        keep = prep.filter_mask.reshape(-1)[flat] & (d_ids >= 0)
        if self.fusion == "zblend":  # the scores ride with their ids
            return mask_compact_ranked_vals(d_ids, d_vals, keep, c)
        ids, surv = mask_compact_ranked(d_ids, keep, c)
        return torch.zeros_like(ids, dtype=torch.float32), ids, surv

    def run_prepared_device(self, prep: PreparedBatch, *, plain: bool = False):
        """The hybrid step over every sub-batch in ``prep``. Returns device
        tensors ((nb, db, k) vals, ids), not yet synchronised, and for a
        filtered batch the dense survivor counts (nb, db) as a third;
        ``finalize_prepared`` copies them back. ``plain`` runs each
        kernel's plain twin instead (to check the kernels against).

        A filtered sub-batch fetches ``c_fetch`` dense candidates, keeps
        the unmasked ones in rank order (the filtered top-c whenever at
        least c survive) and fuses them with the mask-aware BM25 arm."""
        nb, db = prep.queries.shape[:2]
        k, c = prep.k, prep.candidates_per_arm
        filtered = prep.filter_mask is not None
        width = prep.c_fetch if filtered else c
        dense = self.dense
        self._await_staging(prep)
        out_vals, out_ids, out_surv = [], [], []
        for i in range(nb):
            d_vals, d_ids = dense_arm_topk(
                dense.kernel, dense._emb_device, prep.queries[i], width,
                n_docs=self.n_docs, block_c=self._dense_block_c(db),
                candidates=width, rescore_op=dense._rescore_emb,
                q8=prep.queries_i8[i], plain=plain,
            )
            if filtered:
                d_vals, d_ids, surv = self._compact_pool(prep, i, d_vals, d_ids)
                out_surv.append(surv)
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
        out = (torch.stack(out_vals), torch.stack(out_ids))
        return out + (torch.stack(out_surv),) if filtered else out

    def _filtered_fallback(self, prep: PreparedBatch, rows: np.ndarray) -> SearchResult:
        """The exact filtered hybrid for the starved queries (flat indices
        ``rows`` into the padded batch): one masked scan per distinct mask
        row over the resident corpus (the rescore's scores), the rows'
        mask-aware BM25 plans, and fusion. On the caller's current stream,
        after the staging copies."""
        nb, db, dim = prep.queries.shape
        w = prep.plan_doc_ids.shape[2]
        c, k = prep.candidates_per_arm, prep.k
        self._await_staging(prep)
        queries = prep.queries.reshape(nb * db, dim)
        plan_ids = prep.plan_doc_ids.reshape(nb * db, w)
        plan_w = prep.plan_weights.reshape(nb * db, w)

        def arm(g, sub):
            sel = torch.from_numpy(rows[sub]).to(self.device)
            d_vals, d_ids = self.dense._masked_topk(queries[sel], prep.filter_mask[g], c)
            b_vals, b_ids = bm25_topk_device(
                plan_ids[sel], plan_w[sel], self.n_docs, c,
                presorted=prep.presorted, max_run=prep.max_run,
            )
            vals, ids = self._fuse_arms(b_vals, b_ids, d_vals, d_ids, k)
            return vals.cpu().numpy(), ids.cpu().numpy()

        groups = prep.filter_group_host.reshape(nb * db)
        vals, ids = run_per_group(groups[rows], k, arm)
        return SearchResult(ids=ids, scores=vals)

    def run_prepared(self, prep: PreparedBatch) -> SearchResult:
        """``run_prepared_device`` + copy-back of the (b, k) result."""
        if prep.n_queries == 0:
            return SearchResult(
                ids=np.zeros((0, prep.k), np.int32),
                scores=np.zeros((0, prep.k), np.float32),
            )
        return self.finalize_prepared(prep, self.run_prepared_device(prep))

    def copy_back(self, device_out) -> HostCopy:
        """Queue the copy of a ``run_prepared_device`` result (and a
        filtered step's survivor counts) to the host. On the card: into
        pinned buffers on the current stream, right behind the step, with
        an event after it, so that a later wait covers this copy and not
        work queued after it (the next wave's step); on the CPU the
        tensors as they are."""
        if device_out[0].device.type != "cuda":
            return HostCopy(*(t.cpu() for t in device_out[:2]), surv=(
                device_out[2].cpu() if len(device_out) > 2 else None
            ))
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in device_out]
        for dst, src in zip(host, device_out):
            dst.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device_out[0].device))
        return HostCopy(
            host[0], host[1], done, surv=host[2] if len(host) > 2 else None
        )

    def finalize_prepared(self, prep: PreparedBatch, device_out) -> SearchResult:
        """The (b, k) result of ``run_prepared_device`` on the host:
        ``device_out`` is its output, whose copy is queued here, or the
        ``HostCopy`` of an earlier ``copy_back``, whose copy alone is
        waited for. A filtered batch's starved queries (dense survivors
        below min(c, their group's unmasked docs)) are patched with the
        exact masked fallback, so filtered search is exact at any
        selectivity."""
        nb, db = prep.queries.shape[:2]
        b, k = prep.n_queries, prep.k
        copy = device_out if isinstance(device_out, HostCopy) else self.copy_back(device_out)
        if copy.done is not None:
            copy.done.synchronize()
        # copied out of the pinned buffers, which go back to their pool
        ids = np.array(copy.ids.numpy().reshape(nb * db, k)[:b])
        scores = np.array(copy.vals.numpy().reshape(nb * db, k)[:b])
        if prep.filter_mask is not None:
            starved = starved_rows(prep, copy.surv.numpy())
            if starved.size:
                fb = self._filtered_fallback(prep, starved)
                ids[starved] = fb.ids
                scores[starved] = fb.scores
        return SearchResult(ids=ids, scores=scores)

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
