"""The harness's judgement of a live corpus and of RRF: the state-aware
BM25 against a loop over every doc, the near-tie rule, ``invisible``, the
write pool in the inputs, answers tied to their states through a run, the
program driven through its states by hand, and a digest of the existing
cells' reference answers (they read as before the live corpus came)."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from conftest import REPO, run_toy
from portbench.harness import bench, check, data, program, runner
from portbench.harness.window import Window
from portbench.reference.bm25 import ExactBM25
from portbench.reference.fusion import ranked, rrf_scores
from test_portbench_reference import _corpus

SMALL = {
    "n_docs": 3000, "dim": 32, "vocab_size": 400, "store": "bf16", "kernel": "int8", "fusion": "rrf",
    "blend_alpha": 0.7, "device_batch": 64,
    "postings": {"zipf_s": 1.1, "mean_len": 20.0, "tf_p": 0.6, "len_sigma": 0.8},
    "query_model": {"noise": 0.6, "rank_min": 5, "terms": [2, 5]},
}
TRAFFIC = {"queries": {"pool": 256}, "writes": {"pool": 600}}
PLAN = check.Plan(k=10, c=20, fetch=20, hybrid=True)


def _bm25_state_loop(q, tf, doc_len, n_base, n_visible, dead, k1=1.2, b=0.75):
    """Okapi BM25 of every doc under the frozen statistics: avgdl over the
    first n_base docs, N and df over the first n_visible (deleted ones
    counted), only the alive visible docs scored (others -inf)."""
    avgdl = float(doc_len[:n_base].astype(np.float64).mean())
    out = np.full(doc_len.shape[0], -np.inf)
    terms = {}
    for t in q:
        terms[t] = terms.get(t, 0) + 1
    for d in range(n_visible):
        if d in dead:
            continue
        s = 0.0
        for t, qtf in terms.items():
            df = sum(1 for (tt, dd) in tf if tt == t and dd < n_visible)
            f = tf.get((t, d), 0)
            if f:
                idf = np.log1p((n_visible - df + 0.5) / (df + 0.5))
                s += idf * qtf * f * (k1 + 1) / (f + k1 * (1 - b + b * doc_len[d] / avgdl))
        if s > 0:
            out[d] = s
    return out


@pytest.mark.parametrize("n_visible,dead", [(200, ()), (260, ()), (300, (3, 17, 201, 250, 299))],
                         ids=["base", "added", "added-and-deleted"])
def test_bm25_under_a_live_state_matches_a_loop(n_visible, dead):
    offsets, ids, tfs, doc_len, tf = _corpus(n_docs=300)
    ref = ExactBM25(offsets, torch.from_numpy(ids), torch.from_numpy(tfs), torch.from_numpy(doc_len),
                    n_base=200)
    alive = np.zeros(300, bool)
    alive[:n_visible] = True
    alive[list(dead)] = False
    r = np.random.default_rng(4)
    queries = [list(r.integers(1, 41, size=r.integers(1, 6))) for _ in range(12)]
    vals, got = ref.top(queries, 10, torch.from_numpy(alive).expand(12, -1), block=5, n_visible=n_visible)
    for i, q in enumerate(queries):
        scores = _bm25_state_loop(q, tf, doc_len, 200, n_visible, set(dead))
        order = sorted((-s, d) for d, s in enumerate(scores) if np.isfinite(s))[:10]
        assert got[i, : len(order)].tolist() == [d for _, d in order]
        np.testing.assert_allclose(vals[i, : len(order)].numpy(), [-s for s, _ in order], rtol=1e-6)


def _answer(bm25, dense, c=4, k=3):
    """An RRF Answer over hand-made arms (scores, ids), ranked."""
    arms = tuple((np.array(v, np.float32), np.array(i, np.int64)) for v, i in (bm25, dense))
    fused = rrf_scores(arms[0][1][:c], arms[1][1][:c])
    vals, ids = ranked(fused, k)
    return check.Answer(ids, ids, vals, fused, arms=arms, cut=c)


def _served(bm25_ids, dense_ids, k=3):
    fused = rrf_scores(bm25_ids, dense_ids)
    vals, ids = ranked(fused, k)
    return ids, vals.astype(np.float32)


BM25 = ([9.0, 8.99995, 7.0, 6.0, 5.99993], [11, 12, 13, 14, 15])
DENSE = ([0.9, 0.8, 0.7, 0.6, 0.5], [12, 21, 22, 23, 24])


def test_rrf_swap_within_a_near_tie_agrees():
    ans = _answer(BM25, DENSE)
    ids, vals = _served([12, 11, 13, 14], [12, 21, 22, 23])  # 11 and 12 trade ranks
    assert np.abs(vals - ans.vals).max() > 2e-4  # the swap moves the fused scores
    assert check.agrees(ids, vals, ans, 3)
    # a near tie across the cut at c = 4 lets the doc past it in
    ids, vals = _served([11, 12, 13, 15], [12, 21, 22, 23], k=5)
    assert check.agrees(ids, vals, _answer(BM25, DENSE, k=5), 5)


def test_rrf_swap_beyond_a_near_tie_disagrees():
    ans = _answer(BM25, DENSE)
    ids, vals = _served([11, 13, 12, 14], [12, 21, 22, 23])  # 12 and 13 are 2 apart
    assert not check.agrees(ids, vals, ans, 3)
    ids, vals = _served([11, 12, 13, 14], [21, 12, 22, 23])  # no tie in the dense arm
    assert not check.agrees(ids, vals, ans, 3)
    ids, vals = _served([11, 12, 13, 14], [12, 21, 22, 23])
    vals[1] += 3e-4  # the right ids with a wrong score
    assert not check.agrees(ids, vals, ans, 3)


def test_rrf_matches_its_definition():
    a, b = np.array([7, 3, -1, 5]), np.array([3, 9, 7])
    got = rrf_scores(a, b)
    want = {}
    for lst in ([7, 3, 5], [3, 9, 7]):
        for r, d in enumerate(lst):
            want[d] = want.get(d, 0.0) + 1.0 / (60 + r + 1)
    assert got.keys() == want.keys() and all(got[d] == pytest.approx(want[d], abs=1e-15) for d in want)


@pytest.fixture(scope="module")
def small_inputs():
    return runner.make_inputs(SMALL, TRAFFIC, 2**31 + 77, torch.device("cpu"), True)


def test_write_pool_inputs(small_inputs):
    inp = small_inputs
    n = SMALL["n_docs"]
    assert inp.n_base == n and inp.rows.shape[0] == n + 600
    p = inp.postings
    assert p.doc_len.shape[0] == n + 600
    live = data.live_pool(p, inp.rows, n)
    # the base segment: every posting of the first n docs, none after them
    assert live.base.doc_len.shape[0] == n and live.base.doc_ids.max() < n
    assert live.base.offsets[-1] == (p.doc_ids < n).sum()
    # each pooled text holds its doc's postings, and its length is its token count
    term_of = np.repeat(np.arange(p.offsets.shape[0] - 1), np.diff(p.offsets))
    for j in (0, 1, 299, 599):
        d = n + j
        sel = p.doc_ids == d
        want = {f"t{t - 1}": int(f) for t, f in zip(term_of[sel], p.tf[sel])}
        words = live.texts[j].split()
        assert {w: words.count(w) for w in set(words)} == want
        assert p.doc_len[d] == len(words)
    np.testing.assert_array_equal(live.rows, inp.rows[n:].float().numpy())
    # the query pool's targets reach the pooled rows too; no masks with a pool
    with pytest.raises(ValueError):
        runner.make_inputs(SMALL, dict(TRAFFIC, masks=[[0.5, 1]]), 1, torch.device("cpu"), True)


@pytest.mark.parametrize("fusion", ["rrf", "zblend", "sum"])
def test_the_configuration_decides_the_fusion(small_inputs, fusion):
    cfg = dict(SMALL, fusion=fusion)
    if fusion == "sum":
        with pytest.raises(ValueError):
            check.Reference(small_inputs, cfg, PLAN)
        return
    ans = check.Reference(small_inputs, cfg, PLAN).answers(np.arange(8))
    assert all((a.arms is not None) == (fusion == "rrf") for a in ans)
    if fusion == "rrf":
        a = ans[0]
        fused = rrf_scores(a.arms[0][1][: a.cut], a.arms[1][1][: a.cut])
        np.testing.assert_array_equal(ranked(fused, PLAN.k)[1], a.ids)


def test_invisible_counts_deleted_and_unadded_ids(small_inputs):
    n = SMALL["n_docs"]
    states = [(n, 0), (n + 100, 3)]
    deletes = [5, 17, n + 50]
    ref = check.Reference(small_inputs, SMALL, PLAN, states=states, deletes=deletes)
    idx = np.arange(40)
    st = np.array([0] * 20 + [1] * 20)
    truth = ref.answers(idx, st)
    ids = np.array([a.ids for a in truth])
    scores = np.array([a.vals for a in truth], np.float32)
    clean = check.compare(ref, idx, ids, scores, states=st)
    assert clean["invisible"] == 0 and clean["disagree"] == 0.0
    ids[0, 9] = n + 1  # not added in state 0
    ids[25, 9] = 17  # deleted in state 1
    ids[26, 8] = n + 50  # added, then deleted in state 1
    ids[27, 7] = n + 100  # one past the visible docs
    ids[28, 6] = n + 60  # added and alive in state 1: visible
    assert check.compare(ref, idx, ids, scores, states=st)["invisible"] == 4


def test_sample_carries_states():
    ans = [(np.arange(4), np.zeros((4, 2)), np.zeros((4, 2)), 0),
           (np.arange(4, 8), np.ones((4, 2)), np.ones((4, 2)), 1)]
    idx, ids, _, states = check.sample(ans, 6, 9)
    assert (states == (idx >= 4)).all() and (ids[:, 0] == states).all()
    assert check.sample([a[:3] for a in ans], 6, 9)[3] is None
    with pytest.raises(ValueError):
        check.sample([ans[0], ans[1][:3]], 6, 9)


def test_program_through_its_states_agrees(small_inputs):
    """The live corpus driven by hand through deletes before any add (the
    base segment's own step), adds, and deletes after them: every state's
    answers agree with the reference's, and none is invisible."""
    inp, n = small_inputs, SMALL["n_docs"]
    live = data.live_pool(inp.postings, inp.rows, n)
    retr = program.updatable_retriever(SMALL, live.base, inp.rows[:n], inp.pool, "cpu")
    r = np.random.default_rng(3)
    win = Window(t0=0.0, seconds=1.0)
    n_vis, gone = n, []

    def wave(lo):
        idx = np.arange(lo, lo + 64) % len(inp.pool)
        res = retr.search([inp.pool.texts[i] for i in idx], k=10, candidates_per_arm=20,
                          query_embeddings=inp.pool.emb[idx])
        win.states.append((n_vis, len(gone)))
        win.answers.append((idx, res.ids, res.scores, len(win.states) - 1))

    wave(0)
    for step in range(4):
        if step % 2:
            retr.add_documents(live.texts[n_vis - n : n_vis - n + 300], live.rows[n_vis - n : n_vis - n + 300])
            n_vis += 300
        dead = r.choice(np.setdiff1d(np.arange(n_vis), gone), 40, replace=False)
        retr.delete_ids(dead)
        gone += dead.tolist()
        wave(64 * (step + 1))
    ref = check.Reference(inp, SMALL, PLAN, states=win.states, deletes=gone)
    idx, ids, scores, states = check.sample(win.answers, 10_000, 5)
    out = check.compare(ref, idx, ids, scores, states=states)
    assert out["invisible"] == 0 and out["short"] == 0
    assert out["disagree"] <= 0.02, out


def test_live_cell_traced_run_is_correct(toy_root):
    res = run_toy(toy_root, "live", trace=True)
    rec = res.pop("_record")
    assert res["correct"] is True, res["check"]
    assert len(rec["window"].states) == len(rec["window"].answers)
    assert {a[3] for a in rec["window"].answers} == set(range(len(rec["window"].states)))


def test_batch_qps_reads_any_closed_loop():
    read = bench.reader(REPO, "batch_qps")
    win = Window(t0=1.0, seconds=2.0, queries=500)
    win.t1 = 3.5
    for loop, want in (("closed", 200.0), ("open", None)):
        got = read({"cell": {"traffic": {"entry": "anything", "loop": loop}}, "window": win})
        assert got == want


def answers_digest(root, mix: str, seed: int = 2_000_000_033) -> str:
    """A digest of the reference's answers (and the control's) on a toy
    cell: ids exactly, scores to 5 decimals."""
    cell = bench.load_cell(root, f"toy.{mix}", False)
    entry = bench.driver(root, cell.traffic["entry"])
    inputs = runner.make_inputs(cell.config, cell.traffic, seed, torch.device("cpu"), entry.HYBRID)
    plan = entry.plan(cell.config, cell.traffic, inputs)
    idx = np.arange(0, len(inputs.pool), 9)[:160]
    h = hashlib.sha256()
    for low in (False, True):
        for a in check.Reference(inputs, cell.config, plan, low_precision=low).answers(idx):
            h.update(np.asarray(a.exact, np.int64).tobytes())
            h.update(np.asarray(a.ids, np.int64).tobytes())
            h.update(np.round(np.asarray(a.vals, np.float64), 5).tobytes())
            for d, s in sorted(a.scores.items()):
                h.update(np.array([d], np.int64).tobytes() + np.round(np.array([s], np.float64), 5).tobytes())
    return h.hexdigest()


# the digests on the tree before RRF, states and the write pool came
PARENT_DIGESTS = {
    "hybrid-batch": "25adf004b63979dd245c536334f9aadb2f9bc38ee1825494fa34146b29ab0526",
    "dense-batch": "34098be769f74b074a032ce7f826c31b11e5e37b2fa465960b146dd571ff66f1",
    "filtered-batch": "afeaafcd6337a2abbdc54f60664c8dba2bbf1ee166dd0bdf6fd42f376ad935e5",
}


@pytest.mark.parametrize("mix", sorted(PARENT_DIGESTS))
def test_existing_cells_reference_reads_as_before(toy_root, mix):
    assert answers_digest(toy_root, mix) == PARENT_DIGESTS[mix]
