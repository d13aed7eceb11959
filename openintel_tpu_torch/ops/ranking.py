"""Deterministic orderings shared by the port's ops.

The JAX package ends every ranking in a defined order: ``lax.top_k`` keeps
the lowest index among equal values, and two-key ``lax.sort`` orders by
(-score, doc id). ``torch.topk`` promises no order among ties, so the port
builds both from stable sorts.
"""

from __future__ import annotations

import torch


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last axis, ties to the lower index (the
    ``lax.top_k`` rule). Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sort_by_score_then_id(
    scores: torch.Tensor, ids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each row by descending score, ties by ascending id (the
    two-key ``lax.sort((-score, id), num_keys=2)``). Returns the sorted
    (scores, ids)."""
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    scores = torch.gather(scores, -1, by_id)
    ids = torch.gather(ids, -1, by_id)
    by_score = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return torch.gather(scores, -1, by_score), torch.gather(ids, -1, by_score)
