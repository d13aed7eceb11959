"""Rank fusion on the device: reciprocal-rank fusion and the z-score blend.

Port of :mod:`openintel_tpu.ops.fusion` (``rrf_fuse_device``,
``zblend_fuse_device``) as torch ops with the same static-shape
formulation: candidates are the concatenated id lists, per-list
contributions come from an equality match against the lists, duplicates
keep their first occurrence, and the final order is (-fused, doc id) with
ties to the lower doc id. Rankings pad with (0.0, -1).

The filtered step's rank compaction (``mask_compact_ranked``,
``mask_compact_ranked_vals``) lives here too, as in the reference.
"""

from __future__ import annotations

import torch

from openintel_tpu_torch.ops.ranking import sort_by_score_then_id

RRF_K = 60.0
# Lexical weight in the z-blend (dense gets 1 - alpha); the reference's
# measured alpha-sweep winner (openintel_tpu/ops/fusion.py::BLEND_ALPHA).
BLEND_ALPHA = 0.7
_Z_EPS = 1e-6
NEG_INF = float("-inf")


def _compact_order(keep: torch.Tensor) -> torch.Tensor:
    """(B, C) column order that puts the kept entries first, each part in
    its rank order: the sort keys ``pos`` (kept) and ``C + pos`` (the
    rest) are distinct, so the order is the reference's stable sort."""
    cw = keep.shape[1]
    pos = torch.arange(cw, device=keep.device)[None, :]
    return torch.argsort(torch.where(keep, pos, cw + pos), dim=1)


def _fit_columns(x: torch.Tensor, c: int, fill) -> torch.Tensor:
    """The first ``c`` columns of ``x``, padded with ``fill`` when fewer."""
    if x.shape[1] < c:
        x = torch.nn.functional.pad(x, (0, c - x.shape[1]), value=fill)
    return x[:, :c]


def mask_compact_ranked(
    ids: torch.Tensor,  # (B, C) int32 ranked ids, best first; -1 = padding
    keep: torch.Tensor,  # (B, C) bool; False entries are filtered out
    c: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable-compact the surviving entries of ranked id lists. Returns
    ((B, c) ids: the survivors in their rank order, -1 padded; (B,) int32
    survivor counts). Filtering cannot reorder survivors, so when at least
    c survive, the first c are exactly the filtered top-c of the pool."""
    order = _compact_order(keep)
    kept = torch.where(keep, ids, torch.full_like(ids, -1))
    surv = keep.sum(dim=1, dtype=torch.int32)
    return _fit_columns(torch.gather(kept, 1, order), c, -1), surv


def mask_compact_ranked_vals(
    ids: torch.Tensor,  # (B, C) int32 ranked ids, best first; -1 = padding
    vals: torch.Tensor,  # (B, C) scores aligned with ids
    keep: torch.Tensor,  # (B, C) bool; False entries are filtered out
    c: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`mask_compact_ranked` carrying the scores with their ids.
    Returns ((B, c) f32 vals, -inf padded; (B, c) ids, -1 padded; (B,)
    int32 survivor counts)."""
    order = _compact_order(keep)
    kept_vals = torch.where(keep, vals.float(), torch.full_like(vals, NEG_INF, dtype=torch.float32))
    kept_ids = torch.where(keep, ids, torch.full_like(ids, -1))
    surv = keep.sum(dim=1, dtype=torch.int32)
    return (
        _fit_columns(torch.gather(kept_vals, 1, order), c, NEG_INF),
        _fit_columns(torch.gather(kept_ids, 1, order), c, -1),
        surv,
    )


def _first_occurrence(cand: torch.Tensor) -> torch.Tensor:
    """(B, C) bool: the candidate is real (id >= 0) and no earlier column
    holds the same id."""
    c = cand.shape[1]
    col = torch.arange(c, device=cand.device)
    earlier = col[:, None] > col[None, :]  # cand i dupes cand j < i
    dup = torch.any((cand[:, :, None] == cand[:, None, :]) & earlier, dim=2)
    return (cand >= 0) & ~dup


def _rank_and_pad(
    fused: torch.Tensor, cand: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Order by (-fused, id), cut or pad to k columns, pad with (0.0, -1)."""
    vals, ids = sort_by_score_then_id(fused, cand)
    c = cand.shape[1]
    if c < k:  # fewer candidates than requested: pad to the (B, k) contract
        vals = torch.nn.functional.pad(vals, (0, k - c), value=NEG_INF)
        ids = torch.nn.functional.pad(ids, (0, k - c), value=-1)
    vals, ids = vals[:, :k], ids[:, :k]
    invalid = vals == NEG_INF
    return (
        torch.where(invalid, torch.zeros_like(vals), vals),
        torch.where(invalid, torch.full_like(ids, -1), ids),
    )


def rrf_fuse_device(
    ids_a: torch.Tensor,  # (B, Ka) int32 ranked ids (rank 1 first); -1 = padding
    ids_b: torch.Tensor,  # (B, Kb) int32
    k: int,
    rrf_k: float = RRF_K,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fuse two ranked lists; returns (fused_vals (B,k), ids (B,k), -1 padded)."""
    cand = torch.cat([ids_a, ids_b], dim=1)

    def contribution(lst: torch.Tensor) -> torch.Tensor:
        recip = 1.0 / (
            rrf_k
            + torch.arange(
                1, lst.shape[1] + 1, dtype=torch.float32, device=lst.device
            )
        )
        match = (cand[:, :, None] == lst[:, None, :]) & (lst[:, None, :] >= 0)
        return torch.sum(match.float() * recip[None, None, :], dim=2)

    fused = contribution(ids_a) + contribution(ids_b)
    fused = torch.where(
        _first_occurrence(cand), fused, torch.full_like(fused, NEG_INF)
    )
    return _rank_and_pad(fused, cand, k)


def zblend_fuse_device(
    vals_a: torch.Tensor,  # (B, Ka) f32 scores aligned with ids_a
    ids_a: torch.Tensor,  # (B, Ka) int32 ranked ids; -1 = padding
    vals_b: torch.Tensor,  # (B, Kb) f32
    ids_b: torch.Tensor,  # (B, Kb) int32
    k: int,
    alpha: float = BLEND_ALPHA,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Z-normalised score blend of two scored candidate lists.

    Per query and per arm: z = (score - mean) / sqrt(var + eps) over the
    arm's valid entries (ids >= 0); a candidate absent from an arm takes
    the arm's minimum z. Fused = alpha * z_a + (1 - alpha) * z_b, ordered
    by (-fused, doc id)."""
    cand = torch.cat([ids_a, ids_b], dim=1)

    def arm_score(vals: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        valid = ids >= 0
        vf = vals.float()
        zero = torch.zeros_like(vf)
        n = torch.clamp(valid.sum(dim=1, keepdim=True), min=1)
        mean = torch.where(valid, vf, zero).sum(dim=1, keepdim=True) / n
        var = torch.where(valid, (vf - mean) ** 2, zero).sum(
            dim=1, keepdim=True
        ) / n
        z = (vf - mean) / torch.sqrt(var + _Z_EPS)
        # pessimistic fill: an arm that never surfaced the candidate votes
        # with its own worst observed z (0 when the arm is empty)
        fill = torch.where(valid, z, torch.full_like(z, float("inf"))).amin(1)
        fill = torch.where(torch.isfinite(fill), fill, torch.zeros_like(fill))
        # padded entries carry -inf scores, so their z is -inf; zero them
        # BEFORE the masked sum: 0 * (-inf) is NaN
        z = torch.where(valid, z, zero)
        match = (cand[:, :, None] == ids[:, None, :]) & valid[:, None, :]
        s = torch.sum(match.float() * z[:, None, :], dim=2)
        return torch.where(match.any(dim=2), s, fill[:, None])

    fused = alpha * arm_score(vals_a, ids_a) + (1.0 - alpha) * arm_score(
        vals_b, ids_b
    )
    fused = torch.where(
        _first_occurrence(cand), fused, torch.full_like(fused, NEG_INF)
    )
    return _rank_and_pad(fused, cand, k)
