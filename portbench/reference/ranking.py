"""Ranking by (score descending, doc id ascending), padded with (0, -1)."""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def order_by_score_then_id(vals: torch.Tensor, ids: torch.Tensor):
    """Sort each row by (-score, id): a stable sort by id, then a stable
    sort by score descending."""
    by_id = torch.sort(ids, dim=1, stable=True)
    vals = torch.gather(vals, 1, by_id.indices)
    ids = by_id.values
    by_score = torch.sort(vals, dim=1, descending=True, stable=True)
    return by_score.values, torch.gather(ids, 1, by_score.indices)


def top_c(scores: torch.Tensor, c: int, offset: int = 0, margin: int = 8):
    """The best ``c`` entries of each row of ``scores`` by (-score, id),
    ids offset by ``offset``; -inf entries stay -inf. ``margin`` extra
    entries are taken before the tie-ordered cut, so that equal scores at
    the cut resolve to the lower id."""
    take = min(scores.shape[1], c + margin)
    vals, idx = torch.topk(scores, take, dim=1)
    vals, ids = order_by_score_then_id(vals, idx + offset)
    return vals[:, :c], ids[:, :c]


def pad_invalid(vals: torch.Tensor, ids: torch.Tensor, c: int):
    """Cut or pad to ``c`` columns; -inf entries become (0.0, -1)."""
    if vals.shape[1] < c:
        extra = c - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, extra), value=NEG_INF)
        ids = torch.nn.functional.pad(ids, (0, extra), value=-1)
    vals, ids = vals[:, :c], ids[:, :c]
    bad = vals == NEG_INF
    return torch.where(bad, torch.zeros_like(vals), vals), torch.where(bad, torch.full_like(ids, -1), ids)
