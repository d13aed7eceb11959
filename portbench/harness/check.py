"""The comparison that decides ``correct``.

After the window, a sample of the answers it produced (drawn from the
seed; for requests, whole requests, the largest among them) is judged
against the plain reference computed from the same inputs:

- ``disagree``: the share of the sampled queries whose served top-k is
  not the reference's staged answer (the configuration's own
  approximation, below), rank by rank, up to near ties;
- ``score_gap`` (dense cells): the widest gap between a served doc's
  score and its exact score;
- ``short``: served rows with fewer ids than the reference's (exact: 0);
- ``masked``: served ids that their query's filter excludes (exact: 0);
- ``unanswered``: requests due in the window that never came back or
  failed (exact: 0).

``missed``, the share of the exact answer's top-k ids that the served
top-k lacks, is reported as 1 - recall@k and not compared: the staged
answer misses as much by design.

``reference`` with ``low_precision`` is the control: the reference
computed with int8 dense scores and bfloat16 BM25 scores, put in the
program's place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from portbench.harness.data import rng
from portbench.reference.bm25 import ExactBM25
from portbench.reference.dense import doc_scores, exact_top
from portbench.reference.fusion import ranked, zblend_scores
from portbench.reference.ranking import NEG_INF, order_by_score_then_id, pad_invalid

SAMPLE = 512  # answered queries a run compares
BLOCK = 128  # queries per block of the reference
# Two float32 computations of one score in another order of sums differ by
# far less: BM25 sums of <= 8 terms near 10-30 and z-scores near 1.
NEAR_TIE = 1e-4


def sample(answers: list, size: int, seed: int, whole_requests: bool = False):
    """(pool indices (S,), served ids (S, k), served scores (S, k)) of a
    seeded sample of the answered queries."""
    if not answers:
        return np.zeros(0, np.int64), np.zeros((0, 0), np.int64), np.zeros((0, 0))
    r = rng(seed, "sample")
    if whole_requests:
        order = list(r.permutation(len(answers)))
        largest = int(np.argmax([len(a[0]) for a in answers]))
        order.remove(largest)
        picked, n = [], 0
        for j in [largest] + order:
            if n >= size:
                break
            picked.append(j)
            n += len(answers[j][0])
        parts = [answers[j] for j in picked]
        return (
            np.concatenate([p[0] for p in parts]),
            np.concatenate([np.asarray(p[1]) for p in parts]),
            np.concatenate([np.asarray(p[2]) for p in parts]),
        )
    sizes = np.array([len(a[0]) for a in answers])
    starts = np.concatenate([[0], np.cumsum(sizes)])
    flat = np.sort(r.choice(starts[-1], size=min(size, int(starts[-1])), replace=False))
    which = np.searchsorted(starts, flat, side="right") - 1
    rows = flat - starts[which]
    idx = np.array([answers[w][0][i] for w, i in zip(which, rows)])
    ids = np.stack([np.asarray(answers[w][1])[i] for w, i in zip(which, rows)])
    scores = np.stack([np.asarray(answers[w][2])[i] for w, i in zip(which, rows)])
    return idx, ids, scores


@dataclass(frozen=True)
class Plan:
    """The shape of a cell's answers, from its driver: the top-k served,
    the c candidates each arm gives the fusion (k for the dense arm
    alone), the int8 candidates the dense arm fetches for them, and
    whether BM25 and the fusion take part."""

    k: int
    c: int
    fetch: int
    hybrid: bool


@dataclass
class Answer:
    exact: np.ndarray  # (k,) ids of the exact answer
    ids: np.ndarray  # (k,) ids of the staged answer (the configuration's arm)
    vals: np.ndarray  # (k,) its scores
    scores: dict  # {doc id: score} over its candidates


class Reference:
    """The answers of a cell's queries over the cell's inputs.

    ``exact``: exact BM25 over every posting, exact dense over the stored
    rows, fused (or the dense top-k alone). The staged answer follows the
    configuration's dense arm: the reference's own int8 copy of rows and
    queries picks the ``plan.fetch`` best candidates by int8 score, the exact
    scores of those order them; under a filter the unmasked ones are kept,
    and a query whose unmasked candidates fall short of min(c, unmasked
    docs) takes the exact masked answer. With ``low_precision`` (the
    control) the dense scores are the int8 scores themselves and BM25
    scores are bfloat16."""

    def __init__(self, data, cfg: dict, plan: Plan, low_precision: bool = False):
        self.data, self.cfg, self.low = data, cfg, low_precision
        self.k, self.c, self.fetch, self.hybrid = plan.k, plan.c, plan.fetch, plan.hybrid
        if self.hybrid:
            p = data.postings
            self.bm25 = ExactBM25(
                p.offsets, p.doc_ids_dev, p.tf_dev, p.doc_len_dev, low_precision=low_precision
            )
        dev = data.rows.device
        self.masks = torch.from_numpy(data.masks).to(dev) if data.masks is not None else None
        self.unmasked = self.masks.sum(1) if self.masks is not None else None

    def _staged_dense(self, q, masks, groups):
        rows, c = self.data.rows, self.c
        if self.low:
            return exact_top(rows, q, c, masks, low_precision=True)
        _, cand = exact_top(rows, q, min(self.fetch, rows.shape[0]), low_precision=True)
        sc = doc_scores(rows, q, cand)
        keep = cand >= 0
        if masks is not None:
            keep &= torch.gather(masks, 1, cand.clamp(min=0))
        sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
        v, i = order_by_score_then_id(sc, cand)
        v, i = pad_invalid(v, i, c)
        if masks is not None:
            need = torch.clamp(self.unmasked[groups], max=c)
            starved = keep.sum(1) < need
            if starved.any():
                ev, ei = exact_top(rows, q[starved], c, masks[starved])
                v[starved], i[starved] = ev, ei
        return v, i

    def answers(self, idx: np.ndarray) -> list:
        pool, out = self.data.pool, []
        dev = self.data.rows.device
        for s in range(0, len(idx), BLOCK):
            blk = idx[s : s + BLOCK]
            q = torch.from_numpy(pool.emb[blk]).to(dev)
            groups = masks = None
            if self.masks is not None:
                groups = torch.from_numpy(pool.groups[blk]).long().to(dev)
                masks = self.masks[groups]
            sv, si = self._staged_dense(q, masks, groups)
            if self.low:
                ev, ei = sv, si  # the control has no exact answer of its own
            else:
                ev, ei = exact_top(self.data.rows, q, self.c, masks)
            if not self.hybrid:
                for row in range(len(blk)):
                    ids, vals = si[row].cpu().numpy(), sv[row].cpu().numpy()
                    out.append(Answer(ei[row].cpu().numpy(), ids, vals, dict(zip(ids.tolist(), vals.tolist()))))
                continue
            b_v, b_i = self.bm25.top([pool.term_ids[j] for j in blk], self.c, masks)
            b_v, b_i, sv, si, ev, ei = (t.cpu().numpy() for t in (b_v, b_i, sv, si, ev, ei))
            alpha = self.cfg["blend_alpha"]
            for row in range(len(blk)):
                staged = zblend_scores(b_v[row], b_i[row], sv[row], si[row], alpha)
                vals, ids = ranked(staged, self.k)
                exact = ranked(zblend_scores(b_v[row], b_i[row], ev[row], ei[row], alpha), self.k)[1]
                out.append(Answer(exact, ids, vals, staged))
        return out

    def served_scores(self, idx: np.ndarray, ids: np.ndarray) -> Optional[np.ndarray]:
        """The exact score of each served doc, for a dense cell (any doc
        scores exactly); None for a hybrid cell."""
        if self.hybrid:
            return None
        q = torch.from_numpy(self.data.pool.emb[idx]).to(self.data.rows.device)
        t = torch.from_numpy(np.asarray(ids, np.int64)).to(q.device)
        return doc_scores(self.data.rows, q, t).cpu().numpy()


def agrees(ids, scores, ans: Answer, k: int, tol: float = NEAR_TIE) -> bool:
    """The served row equals the staged answer, rank by rank, but for near
    ties: each served score within ``tol`` of the answer's at that rank,
    and a served id that differs from the answer's scoring within ``tol``
    of it."""
    got = [int(d) for d in ids[:k] if d >= 0]
    want = [int(d) for d in ans.ids[:k] if d >= 0]
    if len(got) != len(want):
        return False
    for r, d in enumerate(got):
        if abs(float(scores[r]) - float(ans.vals[r])) > tol:
            return False
        if d != want[r] and abs(ans.scores.get(d, np.inf) - float(ans.vals[r])) > tol:
            return False
    return True


def compare(ref: Reference, idx, ids, scores, masks=None, groups=None) -> dict:
    """The compared numbers of served (ids, scores) for the pool queries idx."""
    k = ref.k
    truth = ref.answers(idx)
    exact = ref.served_scores(idx, ids)
    hits = total = short = masked = disagree = 0
    gap = 0.0
    for row, ans in enumerate(truth):
        got = [int(d) for d in ids[row][:k] if d >= 0]
        want = [int(d) for d in ans.exact if d >= 0]
        hits += len(set(got) & set(want))
        total += len(want)
        short += len(got) < len([d for d in ans.ids if d >= 0])
        disagree += not agrees(ids[row], scores[row], ans, k)
        if masks is not None:
            masked += sum(1 for d in got if not masks[groups[row], d])
        if exact is not None:
            for j, d in enumerate(ids[row][:k]):
                if d >= 0:
                    gap = max(gap, abs(float(scores[row][j]) - float(exact[row][j])))
    out = {
        "missed": 1.0 - hits / total if total else 0.0,
        "disagree": disagree / len(truth) if truth else 0.0,
        "short": short,
        "queries": len(truth),
    }
    if exact is not None:
        out["score_gap"] = gap
    if masks is not None:
        out["masked"] = masked
    return out


def control_answers(ref_low: Reference, idx: np.ndarray):
    """The control in the program's place: the low-precision reference's
    own top-k (ids, scores) for the queries idx."""
    truth = ref_low.answers(idx)
    return np.array([a.ids for a in truth]), np.array([a.vals for a in truth])


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """correct, and {name: {"value", "limit"}} for every limited number."""
    shown = {n: {"value": numbers[n], "limit": lim} for n, lim in limits.items() if n in numbers}
    missing = [n for n in limits if n not in numbers]
    ok = not missing and all(v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
