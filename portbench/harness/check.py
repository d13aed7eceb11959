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

Fusion is the configuration's (``cfg["fusion"]``, as the program is
served): the z-score blend or reciprocal-rank fusion (RRF).
Under RRF a near tie moves more than the fused score's own round-off: two
docs within ``NEAR_TIE`` in one arm may trade ranks there, and the swap
moves their fused scores by 1/(60 + r) - 1/(61 + r), about 2.6e-4 at the
top. So an RRF row agrees when some order of each arm's runs of near-tied
docs (a run crossing the arm's cut at c may bring in the docs past it)
yields the served row, rank by rank, with fused scores within
``RRF_TIE``. A swap beyond a near tie still disagrees; a row whose runs
allow more than ``MAX_ORDERS`` orders counts as disagreeing.

A live corpus (``models/updatable.py``): an answer may name the state it
was served from, (n_visible, n_dead) of ``Window.states``: the docs below
n_visible were added (the first ``n_base`` are the base segment, the rest
came from the write pool in order) and the first n_dead ids of
``Window.deletes`` deleted, each acknowledged before the wave was sent.
Such an answer is judged against its own state:

- BM25: ``avgdl`` over the base segment; N = n_visible and df over the
  docs below it, deleted ones included; only the alive visible docs rank.
- Dense, staged: the base segment as the configuration's int8 arm
  stages it, over-fetched under deletes at
  ``filtered_fetch_width(c, n_base, alive base docs)`` with the starved-row
  rule above; the docs from ``n_base`` on scored exactly.
- Each arm's two segments merged by (score descending, id ascending) to
  c, then fused.
- ``invisible``: served ids not alive in the answer's state, deleted
  before the wave was sent or not yet added (exact: 0); compared where a
  cell's limits name it.

Where this departs from ``updatable.py``'s documented contract, or says
what it leaves open:

- BM25 is exact over every posting; the program's plans prune each
  term's postings above 100,000 docs (as in the static cells: a source of
  ``disagree``, not a fault).
- Before the first add the program searches the base segment's own step
  (int8 candidates: the over-fetch width); after it, each segment's dense
  arm on its own, the base's at the arm's default of max(2 x width, 32)
  int8 candidates. The staged answer follows the path of its state.
- A pooled doc's length is its token count, the text the program is
  given (``data.live_pool``).
- Not modelled: compaction (it renumbers ids; a state cannot name it),
  filters beside deletes (a mix with writes takes no masks), and a write
  acknowledged while a wave is in flight.

Answers without a state are judged as before this was added.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from portbench.harness.data import rng
from portbench.reference.bm25 import ExactBM25
from portbench.reference.dense import doc_scores, exact_top, filtered_fetch_width
from portbench.reference.fusion import ranked, rrf_scores, zblend_scores
from portbench.reference.ranking import NEG_INF, order_by_score_then_id, pad_invalid
from portbench.roofline import arm_candidates

SAMPLE = 512  # answered queries a run compares
BLOCK = 128  # queries per block of the reference
# Two float32 computations of one score in another order of sums differ by
# far less: BM25 sums of <= 8 terms near 10-30 and z-scores near 1.
NEAR_TIE = 1e-4
# An RRF score is a float32 sum of two reciprocals near 1/61: its round-off
# is below 1e-8, and two different rank pairs differ by far more.
RRF_TIE = 1e-6
TIE_MARGIN = 8  # entries past an arm's cut that a near tie there may bring in
MAX_ORDERS = 4096  # orders of near-tied runs an RRF row is tried in


def _states_of(answers: list, which) -> Optional[np.ndarray]:
    """The state of each answer in ``which``, or None where no answer
    names one."""
    named = {len(a) > 3 for a in answers}
    if named == {False}:
        return None
    if len(named) > 1:
        raise ValueError("some answers name a corpus state and some do not")
    return np.array([answers[w][3] for w in which], np.int64)


def sample(answers: list, size: int, seed: int, whole_requests: bool = False):
    """(pool indices (S,), served ids (S, k), served scores (S, k), states
    (S,) or None) of a seeded sample of the answered queries."""
    if not answers:
        return np.zeros(0, np.int64), np.zeros((0, 0), np.int64), np.zeros((0, 0)), None
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
        states = _states_of(answers, [j for j in picked for _ in answers[j][0]])
        return (
            np.concatenate([p[0] for p in parts]),
            np.concatenate([np.asarray(p[1]) for p in parts]),
            np.concatenate([np.asarray(p[2]) for p in parts]),
            states,
        )
    sizes = np.array([len(a[0]) for a in answers])
    starts = np.concatenate([[0], np.cumsum(sizes)])
    flat = np.sort(r.choice(starts[-1], size=min(size, int(starts[-1])), replace=False))
    which = np.searchsorted(starts, flat, side="right") - 1
    rows = flat - starts[which]
    idx = np.array([answers[w][0][i] for w, i in zip(which, rows)])
    ids = np.stack([np.asarray(answers[w][1])[i] for w, i in zip(which, rows)])
    scores = np.stack([np.asarray(answers[w][2])[i] for w, i in zip(which, rows)])
    return idx, ids, scores, _states_of(answers, which)


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
    # RRF only: each arm's staged (scores, ids), ranked, past the cut at c
    # by up to TIE_MARGIN entries (the near-tie rule)
    arms: Optional[tuple] = None
    cut: int = 0


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
    scores are bfloat16. ``states`` and ``deletes`` are a live corpus's
    (``Window.states``, ``Window.deletes``), for answers that name a
    state."""

    def __init__(self, data, cfg: dict, plan: Plan, low_precision: bool = False,
                 states=(), deletes=()):
        self.data, self.cfg, self.low = data, cfg, low_precision
        self.k, self.c, self.fetch, self.hybrid = plan.k, plan.c, plan.fetch, plan.hybrid
        self.fusion = cfg["fusion"] if self.hybrid else None
        if self.fusion not in (None, "zblend", "rrf"):
            raise ValueError(f"no reference for fusion {self.fusion!r}")
        self.n_base = data.n_base
        self.states = list(states)
        self.deletes = np.asarray(deletes, np.int64)
        if self.states and not self.hybrid:
            raise ValueError("corpus states are judged for a hybrid plan only")
        if self.hybrid:
            p = data.postings
            self.bm25 = ExactBM25(
                p.offsets, p.doc_ids_dev, p.tf_dev, p.doc_len_dev, low_precision=low_precision,
                n_base=data.n_base,
            )
        dev = data.rows.device
        self.masks = torch.from_numpy(data.masks).to(dev) if data.masks is not None else None
        self.unmasked = self.masks.sum(1) if self.masks is not None else None

    def _staged_dense(self, rows, q, fetch, masks=None, need=None, width=None, take=None):
        """The configuration's dense arm over ``rows``: the ``fetch`` best
        candidates by int8 score, ordered by exact score and cut to
        ``width`` (all of them by default), the unmasked kept; a row whose
        kept candidates fall short of ``need`` takes the exact masked
        answer. ``take`` columns (c by default)."""
        take = take or self.c
        if self.low:
            return exact_top(rows, q, take, masks, low_precision=True)
        _, cand = exact_top(rows, q, min(fetch, rows.shape[0]), low_precision=True)
        sc = doc_scores(rows, q, cand)
        if width is not None and width < cand.shape[1]:
            sc, cand = order_by_score_then_id(torch.where(cand >= 0, sc, NEG_INF), cand)
            sc, cand = sc[:, :width], cand[:, :width]
        keep = cand >= 0
        if masks is not None:
            keep &= torch.gather(masks, 1, cand.clamp(min=0))
        sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
        v, i = order_by_score_then_id(sc, cand)
        v, i = pad_invalid(v, i, take)
        if masks is not None:
            starved = keep.sum(1) < need
            if starved.any():
                ev, ei = exact_top(rows, q[starved], take, masks[starved])
                v[starved], i[starved] = ev, ei
        return v, i

    def answers(self, idx: np.ndarray, states: Optional[np.ndarray] = None) -> list:
        """The Answer of each pool query ``idx``, under its corpus state
        where ``states`` names one."""
        if states is None:
            return self._answers(idx)
        out = [None] * len(idx)
        for s in np.unique(states):
            where = np.flatnonzero(states == s)
            for b in range(0, len(where), BLOCK):
                blk = where[b : b + BLOCK]
                for j, ans in zip(blk, self._state_answers(idx[blk], int(s))):
                    out[j] = ans
        return out

    def _take(self) -> int:
        """Columns of each staged arm: past the cut for RRF's near ties."""
        return self.c + TIE_MARGIN if self.fusion == "rrf" else self.c

    def _answers(self, idx: np.ndarray) -> list:
        pool, out = self.data.pool, []
        dev = self.data.rows.device
        take = self._take()
        for s in range(0, len(idx), BLOCK):
            blk = idx[s : s + BLOCK]
            q = torch.from_numpy(pool.emb[blk]).to(dev)
            groups = masks = need = None
            if self.masks is not None:
                groups = torch.from_numpy(pool.groups[blk]).long().to(dev)
                masks = self.masks[groups]
                need = torch.clamp(self.unmasked[groups], max=self.c)
            sv, si = self._staged_dense(self.data.rows, q, self.fetch, masks, need, take=take)
            if self.low:
                ev, ei = sv, si  # the control has no exact answer of its own
            else:
                ev, ei = exact_top(self.data.rows, q, self.c, masks)
            if not self.hybrid:
                for row in range(len(blk)):
                    ids, vals = si[row].cpu().numpy(), sv[row].cpu().numpy()
                    out.append(Answer(ei[row].cpu().numpy(), ids, vals, dict(zip(ids.tolist(), vals.tolist()))))
                continue
            b_v, b_i = self.bm25.top([pool.term_ids[j] for j in blk], take, masks)
            out += self._fused(b_v, b_i, sv, si, ev, ei)
        return out

    def _state_answers(self, blk: np.ndarray, state: int) -> list:
        """Answers of the pool queries ``blk`` over the live corpus in
        ``state`` (the module's docstring)."""
        n_vis, n_dead = self.states[state]
        rows, nb, c = self.data.rows, self.n_base, self.c
        dev, b = rows.device, len(blk)
        take = self._take()
        alive = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
        alive[:n_vis] = True
        alive[torch.from_numpy(self.deletes[:n_dead]).to(dev)] = False
        q = torch.from_numpy(self.data.pool.emb[blk]).to(dev)
        n_alive = int(alive[:nb].sum())
        masks = need = None
        width = c
        if n_alive < nb:
            masks = alive[:nb].expand(b, nb)
            need = torch.full((b,), min(c, n_alive), device=dev)
            width = filtered_fetch_width(c, nb, n_alive)
        fetch = width if n_vis == nb else min(arm_candidates(width, None), nb)
        sv, si = self._staged_dense(rows[:nb], q, fetch, masks, need, width=width, take=take)
        if n_vis > nb:
            dv, di = exact_top(rows[nb:n_vis], q, take, alive[nb:n_vis].expand(b, -1),
                               low_precision=self.low)
            sv, si = _merge(sv, si, dv, torch.where(di >= 0, di + nb, di), take)
        if self.low:
            ev, ei = sv, si  # the control has no exact answer of its own
        else:
            ev, ei = exact_top(rows[:n_vis], q, c, alive[:n_vis].expand(b, -1))
        b_v, b_i = self.bm25.top([self.data.pool.term_ids[j] for j in blk], take,
                                 alive.expand(b, -1), n_visible=n_vis)
        return self._fused(b_v, b_i, sv, si, ev, ei)

    def _fused(self, b_v, b_i, sv, si, ev, ei) -> list:
        """One Answer a row from each arm's staged (scores, ids), and the
        exact dense answer's, fused by the configuration's fusion."""
        b_v, b_i, sv, si, ev, ei = (t.cpu().numpy() for t in (b_v, b_i, sv, si, ev, ei))
        k, c, out = self.k, self.c, []
        for row in range(b_v.shape[0]):
            if self.fusion == "rrf":
                staged = rrf_scores(b_i[row][:c], si[row][:c])
                vals, ids = ranked(staged, k)
                exact = ranked(rrf_scores(b_i[row][:c], ei[row][:c]), k)[1]
                arms = ((b_v[row], b_i[row]), (sv[row], si[row]))
                out.append(Answer(exact, ids, vals, staged, arms=arms, cut=c))
                continue
            alpha = self.cfg["blend_alpha"]
            staged = zblend_scores(b_v[row], b_i[row], sv[row], si[row], alpha)
            vals, ids = ranked(staged, k)
            exact = ranked(zblend_scores(b_v[row], b_i[row], ev[row], ei[row], alpha), k)[1]
            out.append(Answer(exact, ids, vals, staged))
        return out

    def alive(self, state: int, ids) -> np.ndarray:
        """Which of ``ids`` are alive in ``state``: added and not deleted."""
        n_vis, n_dead = self.states[state]
        ids = np.asarray(ids, np.int64)
        return (ids < n_vis) & ~np.isin(ids, self.deletes[:n_dead])

    def served_scores(self, idx: np.ndarray, ids: np.ndarray) -> Optional[np.ndarray]:
        """The exact score of each served doc, for a dense cell (any doc
        scores exactly); None for a hybrid cell."""
        if self.hybrid:
            return None
        q = torch.from_numpy(self.data.pool.emb[idx]).to(self.data.rows.device)
        t = torch.from_numpy(np.asarray(ids, np.int64)).to(q.device)
        return doc_scores(self.data.rows, q, t).cpu().numpy()


def _merge(va, ia, vb, ib, c: int):
    """Two ranked (scores, ids) lists merged by (score descending, id
    ascending), cut or padded to c with (0.0, -1)."""
    v, i = torch.cat([va, vb], 1), torch.cat([ia, ib], 1)
    v, i = order_by_score_then_id(torch.where(i >= 0, v, torch.full_like(v, NEG_INF)), i)
    return pad_invalid(v, i, c)


def _same_row(ids, scores, want_ids, want_vals, want_scores: dict, k: int, tol: float) -> bool:
    """The served row is the wanted one, rank by rank, up to ties within
    ``tol``."""
    got = [int(d) for d in ids[:k] if d >= 0]
    want = [int(d) for d in want_ids[:k] if d >= 0]
    if len(got) != len(want):
        return False
    for r, d in enumerate(got):
        if abs(float(scores[r]) - float(want_vals[r])) > tol:
            return False
        if d != want[r] and abs(want_scores.get(d, np.inf) - float(want_vals[r])) > tol:
            return False
    return True


def _arm_orders(vals, ids, cut: int) -> list:
    """Each order of the arm's first ``cut`` ids that its runs of near-tied
    docs allow: a run is a stretch of valid entries, each within NEAR_TIE of
    the one before it; one that crosses the cut lets its docs past the cut
    in."""
    ids = [int(d) for d in ids]
    n = sum(1 for d in ids if d >= 0)
    runs, a = [], 0
    while a < min(n, cut):
        b = a + 1
        while b < n and float(vals[b - 1]) - float(vals[b]) <= NEAR_TIE:
            b += 1
        if b - a > 1:
            runs.append((a, b))
        a = b
    head = ids[:cut]
    if math.prod(math.perm(b - a, min(b, cut) - a) for a, b in runs) > MAX_ORDERS:
        return []
    choices = [list(itertools.permutations(ids[a:b], min(b, cut) - a)) for a, b in runs]
    orders = []
    for pick in itertools.product(*choices):
        order = list(head)
        for (a, b), part in zip(runs, pick):
            order[a : a + len(part)] = part
        orders.append(order)
    return orders


def agrees(ids, scores, ans: Answer, k: int, tol: float = NEAR_TIE) -> bool:
    """The served row equals the staged answer, rank by rank, but for near
    ties: each served score within ``tol`` of the answer's at that rank,
    and a served id that differs from the answer's scoring within ``tol``
    of it. Under RRF, the same for some order of the arms' near-tied runs,
    with fused scores within RRF_TIE (the module's docstring)."""
    if ans.arms is None:
        return _same_row(ids, scores, ans.ids, ans.vals, ans.scores, k, tol)
    if _same_row(ids, scores, ans.ids, ans.vals, ans.scores, k, RRF_TIE):
        return True
    per_arm = [_arm_orders(v, i, ans.cut) for v, i in ans.arms]
    if math.prod(len(x) for x in per_arm) > MAX_ORDERS:
        return False
    for lists in itertools.product(*per_arm):
        fused = rrf_scores(*lists)
        vals, want = ranked(fused, k)
        if _same_row(ids, scores, want, vals, fused, k, RRF_TIE):
            return True
    return False


def compare(ref: Reference, idx, ids, scores, masks=None, groups=None, states=None) -> dict:
    """The compared numbers of served (ids, scores) for the pool queries
    idx, each under its corpus state where ``states`` names one."""
    k = ref.k
    truth = ref.answers(idx, states)
    exact = ref.served_scores(idx, ids)
    hits = total = short = masked = disagree = invisible = 0
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
        if states is not None:
            invisible += int((~ref.alive(int(states[row]), got)).sum())
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
    if states is not None:
        out["invisible"] = invisible
    return out


def control_answers(ref_low: Reference, idx: np.ndarray, states: Optional[np.ndarray] = None):
    """The control in the program's place: the low-precision reference's
    own top-k (ids, scores) for the queries idx (under their states)."""
    truth = ref_low.answers(idx, states)
    return np.array([a.ids for a in truth]), np.array([a.vals for a in truth])


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """correct, and {name: {"value", "limit"}} for every limited number."""
    shown = {n: {"value": numbers[n], "limit": lim} for n, lim in limits.items() if n in numbers}
    missing = [n for n in limits if n not in numbers]
    ok = not missing and all(v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
