"""Dense cosine retrieval: blocked query x corpus product with a running top-k.

Port of :mod:`openintel_tpu.ops.dense`: :func:`dense_topk_xla`, the exact
path on the CPU and the oracle of the dense kernels, and its masked forms
:func:`dense_topk_xla_masked` and :func:`dense_topk_masked_t`, the exact
arm of filtered search. The product of each corpus block is a plain
``torch.matmul`` in true float32 (the JAX program's
``Precision.HIGHEST``; TF32 must be off on the card, see
:func:`require_true_f32`). Ties break by ascending doc id: the running list
precedes the block and blocks scan in ascending doc order, and the
selection is a stable sort.
"""

from __future__ import annotations

from typing import Optional

import torch

from openintel_tpu_torch.ops.ranking import stable_topk

NEG_INF = float("-inf")


def require_true_f32() -> None:
    """Turn TF32 off for float32 products on the card. The exact paths and
    the rescore stage are defined in true float32 (rescore precision was a
    measured recall fix in the reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _scan_topk(
    doc_emb: torch.Tensor,  # (>= n_docs, >= D) rows; only [:n_docs, :D] read
    queries: torch.Tensor,  # (B, D)
    k: int,
    n_docs: int,
    block_size: int,
    doc_mask: Optional[torch.Tensor],  # (n_docs,) bool, or None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The running top-k over the first ``n_docs`` rows, their first D
    columns (zero-padded feature columns add nothing to a dot); masked
    docs score -inf."""
    require_true_f32()
    b, dim = queries.shape
    q = queries.float()
    vals = torch.full((b, k), NEG_INF, dtype=torch.float32, device=q.device)
    ids = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    for start in range(0, n_docs, block_size):
        stop = min(start + block_size, n_docs)
        block = doc_emb[start:stop]
        if block.shape[1] != dim:
            block = block[:, :dim]
        scores = q @ block.float().T  # (B, block)
        if doc_mask is not None:
            scores = torch.where(
                doc_mask[None, start:stop], scores, torch.full_like(scores, NEG_INF)
            )
        gids = torch.arange(start, stop, dtype=torch.int32, device=q.device)
        ext_vals = torch.cat([vals, scores], dim=1)
        ext_ids = torch.cat([ids, gids[None, :].expand(b, -1)], dim=1)
        vals, sel = stable_topk(ext_vals, k)
        ids = torch.gather(ext_ids, 1, sel)
    return vals, ids


def dense_topk_xla(
    doc_emb: torch.Tensor,  # (N, D) unit-norm rows (f32 or bf16)
    queries: torch.Tensor,  # (B, D) unit-norm rows
    k: int,
    block_size: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked brute-force cosine top-k. Returns (vals (B,k) f32, ids (B,k)
    int32); k is clamped to the corpus size."""
    n_docs = doc_emb.shape[0]
    return _scan_topk(doc_emb, queries, min(k, n_docs), n_docs, block_size, None)


def _pad_unfilled(vals, ids):
    """Slots no unmasked doc filled (-inf) become (0.0, -1)."""
    pad = vals == NEG_INF
    return (
        torch.where(pad, torch.zeros_like(vals), vals),
        torch.where(pad, torch.full_like(ids, -1), ids),
    )


def dense_topk_xla_masked(
    doc_emb: torch.Tensor,  # (>= n_docs, >= D) unit-norm rows (f32 or bf16)
    queries: torch.Tensor,  # (B, D) unit-norm rows
    doc_mask: torch.Tensor,  # (n_docs,) bool; False docs never rank
    k: int,
    block_size: int = 4096,
    *,
    n_docs: Optional[int] = None,  # rows that rank (default: all of them)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked brute-force cosine top-k: exact filtered retrieval at any
    selectivity (the starved-query fallback of the filtered hybrid).
    Returns (vals (B,k), ids (B,k)), padded (0.0, -1) when fewer than k
    docs survive the mask. Only the first ``n_docs`` rows rank; rows wider
    than the queries (feature columns zero-padded at load) are read at the
    queries' width."""
    n_docs = doc_emb.shape[0] if n_docs is None else n_docs
    return _pad_unfilled(
        *_scan_topk(doc_emb, queries, min(k, n_docs), n_docs, block_size, doc_mask.bool())
    )


def dense_topk_masked_t(
    doc_emb: torch.Tensor,  # (N_pad, D_pad) kernel D's padded row-major corpus
    queries: torch.Tensor,  # (B, D) unit-norm rows
    doc_mask: torch.Tensor,  # (n_docs,) bool
    k: int,
    *,
    n_docs: int,
    block_size: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's masked scan over the fast arm's corpus, under its
    name. The reference's operand is the transposed (D, N_pad) copy; the
    port's is row-major (``convert.fast_corpus``: rows zero-padded to whole
    supers, features to 16 columns), so this takes those rows and the true
    ``n_docs`` and gives what the reference function gives on the
    transposed copy of the same rows: :func:`dense_topk_xla_masked` over
    the first ``n_docs`` rows."""
    return dense_topk_xla_masked(doc_emb, queries, doc_mask, k, block_size, n_docs=n_docs)
