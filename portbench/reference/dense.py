"""Exact dense top-c over the stored rows, in blocks of rows.

Scores are float32 dot products of the float32 queries with the stored
rows widened to float32, TF32 off. With ``low_precision`` (the control)
both sides go through the int8 quantiser first and a score is the int8
dot over 127**2, which float32 holds exactly (|dot| < 2**24).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from portbench.reference.quant import quantize_int8
from portbench.reference.ranking import NEG_INF, order_by_score_then_id, pad_invalid, top_c


@contextlib.contextmanager
def true_f32():
    """Float32 products without TF32, restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _block_scores(rows: torch.Tensor, q: torch.Tensor, low: bool) -> torch.Tensor:
    if low:
        return (q @ quantize_int8(rows).float().T) / (127.0 * 127.0)
    return q @ rows.float().T


def exact_top(
    rows: torch.Tensor,  # (N, D) stored rows (bf16 or f32) on the device
    queries: torch.Tensor,  # (B, D) f32
    c: int,
    masks: Optional[torch.Tensor] = None,  # (B, N) bool
    *,
    block: int = 1 << 18,
    low_precision: bool = False,
):
    """((B, c) f32 scores, (B, c) int64 ids) of the exact top-c, padded
    with (0.0, -1)."""
    q = queries.float()
    if low_precision:
        q = quantize_int8(q).float()
    best_v = torch.empty((q.shape[0], 0), device=q.device)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.long, device=q.device)
    with true_f32():
        for s in range(0, rows.shape[0], block):
            sc = _block_scores(rows[s : s + block], q, low_precision)
            if masks is not None:
                sc = torch.where(masks[:, s : s + block], sc, torch.full_like(sc, NEG_INF))
            v, i = top_c(sc, c, offset=s)
            v, i = order_by_score_then_id(torch.cat([best_v, v], 1), torch.cat([best_i, i], 1))
            best_v, best_i = v[:, :c], i[:, :c]
    return pad_invalid(best_v, best_i, c)


FILTER_FETCH_CAP = 1024  # the widest over-fetch of a filtered dense arm


def filtered_fetch_width(c: int, n_docs: int, n_unmasked: int) -> int:
    """The dense arm's over-fetch under a filter keeping ``n_unmasked`` of
    ``n_docs`` docs, as the configuration's filtered search states it:
    enough candidates that c survive twice over at the mask's share, a
    power of two from 64, at most FILTER_FETCH_CAP and n_docs."""
    if n_unmasked <= 0:
        return min(max(c, 1), n_docs)
    want = max(2 * c, math.ceil(c / (n_unmasked / n_docs)))
    width = 64
    while width < want and width < FILTER_FETCH_CAP:
        width *= 2
    return min(max(width, c), FILTER_FETCH_CAP, n_docs)


def doc_scores(
    rows: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor, *, low_precision: bool = False
) -> torch.Tensor:
    """(B, m) exact scores of the docs ``ids`` (B, m) (ids < 0 score 0)."""
    q = queries.float()
    cand = rows[ids.clamp(min=0)].float()
    if low_precision:
        q = quantize_int8(q).float()
        cand = quantize_int8(cand).float()
    with true_f32():
        sc = (cand * q[:, None, :]).sum(-1)
    if low_precision:
        sc = sc / (127.0 * 127.0)
    return torch.where(ids >= 0, sc, torch.zeros_like(sc))
