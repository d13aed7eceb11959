"""Dense cosine retrieval: blocked query x corpus product with a running top-k.

Port of :func:`openintel_tpu.ops.dense.dense_topk_xla`: the exact path on
the CPU and the oracle of the dense kernels. The product of each corpus
block is a plain ``torch.matmul`` in true float32 (the JAX program's
``Precision.HIGHEST``; TF32 must be off on the card, see
:func:`require_true_f32`). Ties break by ascending doc id: the running list
precedes the block and blocks scan in ascending doc order, and the
selection is a stable sort.
"""

from __future__ import annotations

import torch

from openintel_tpu_torch.ops.ranking import stable_topk

NEG_INF = float("-inf")


def require_true_f32() -> None:
    """Turn TF32 off for float32 products on the card. The exact paths and
    the rescore stage are defined in true float32 (rescore precision was a
    measured recall fix in the reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dense_topk_xla(
    doc_emb: torch.Tensor,  # (N, D) unit-norm rows (f32 or bf16)
    queries: torch.Tensor,  # (B, D) unit-norm rows
    k: int,
    block_size: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked brute-force cosine top-k. Returns (vals (B,k) f32, ids (B,k)
    int32); k is clamped to the corpus size."""
    require_true_f32()
    n_docs = doc_emb.shape[0]
    b = queries.shape[0]
    k = min(k, n_docs)
    q = queries.float()
    vals = torch.full((b, k), NEG_INF, dtype=torch.float32, device=q.device)
    ids = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    for start in range(0, n_docs, block_size):
        block = doc_emb[start : start + block_size].float()
        scores = q @ block.T  # (B, block)
        gids = torch.arange(
            start, start + block.shape[0], dtype=torch.int32, device=q.device
        )
        ext_vals = torch.cat([vals, scores], dim=1)
        ext_ids = torch.cat([ids, gids[None, :].expand(b, -1)], dim=1)
        vals, sel = stable_topk(ext_vals, k)
        ids = torch.gather(ext_ids, 1, sel)
    return vals, ids
