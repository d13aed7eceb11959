"""Fusion of two ranked candidate lists, one query at a time: the z-score
blend and reciprocal-rank fusion.

z-score blend: per arm, over its valid entries (id >= 0): z = (score - mean) /
sqrt(var + 1e-6), var the population variance; a candidate the arm did
not return takes the arm's lowest z (0 for an empty arm). fused = alpha *
z_lexical + (1 - alpha) * z_dense. Candidates are the lexical list then
the dense list, each id once; the result is ordered by (-fused, id), cut
to k and padded with (0.0, -1).

Reciprocal-rank fusion (Cormack, Clarke and Buettcher, SIGIR 2009):
score(d) = sum over the arms that return d of 1 / (k + rank(d)), rank
counted from 1 over the arm's valid entries, k = 60.
"""

from __future__ import annotations

import numpy as np

Z_EPS = 1e-6
RRF_K = 60.0


def _z(vals: np.ndarray, ids: np.ndarray) -> tuple[dict, float]:
    valid = ids >= 0
    if not valid.any():
        return {}, 0.0
    v = vals[valid].astype(np.float64)
    z = (v - v.mean()) / np.sqrt(v.var() + Z_EPS)
    return dict(zip(ids[valid].tolist(), z.tolist())), float(z.min())


def zblend_scores(b_vals, b_ids, d_vals, d_ids, alpha: float) -> dict:
    """Every candidate's fused score, {doc id: fused}."""
    zb, fill_b = _z(np.asarray(b_vals), np.asarray(b_ids))
    zd, fill_d = _z(np.asarray(d_vals), np.asarray(d_ids))
    out = {}
    for d in list(zb) + list(zd):
        if d not in out:
            out[d] = alpha * zb.get(d, fill_b) + (1.0 - alpha) * zd.get(d, fill_d)
    return out


def rrf_scores(*arms, k: float = RRF_K) -> dict:
    """Every candidate's fused score, {doc id: fused}, over ranked id lists
    (best first, -1 padding); candidates in order of first appearance."""
    out = {}
    for ids in arms:
        valid = [d for d in np.asarray(ids).tolist() if d >= 0]
        for rank, d in enumerate(valid, start=1):
            out[d] = out.get(d, 0.0) + 1.0 / (k + rank)
    return out


def ranked(fused: dict, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The top-k of {doc id: fused} by (-fused, id), padded with (0, -1)."""
    order = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    ids = np.full(k, -1, np.int64)
    vals = np.zeros(k, np.float64)
    for j, (d, s) in enumerate(order):
        ids[j], vals[j] = d, s
    return vals, ids
