"""C++ plan builder vs the NumPy reference path: identical candidate sets,
identical device results (the native analogue of parser-fixture parity —
reference test strategy: canned inputs through both implementations)."""

import dataclasses

import numpy as np
import pytest

from openintel_tpu import native
from openintel_tpu.index.synthetic import synthetic_postings_index
from openintel_tpu.ops import reference as ref
from openintel_tpu.ops.bm25 import bm25_topk_device, build_query_plan
from openintel_tpu_torch import convert
from openintel_tpu_torch import native as tnative
from openintel_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def lib():
    native.build()
    if native._load() is None:  # pragma: no cover - toolchain always present
        pytest.skip("native library unavailable")
    return True


@pytest.fixture(scope="module")
def idx():
    return synthetic_postings_index(20_000, vocab_size=400, mean_len=12, seed=51)


def _queries(rng, n, lo=1, hi=100, t=4):
    return [list(rng.integers(lo, hi, size=t)) for _ in range(n)]


def test_native_plan_matches_numpy_plan_results(lib, idx):
    rng = np.random.default_rng(52)
    term_ids = _queries(rng, 16)

    p_nat = build_query_plan(idx, term_ids, max_postings_per_term=64)
    p_py = build_query_plan(
        idx, term_ids, max_postings_per_term=64, use_native=False
    )
    assert p_nat.presorted and p_py.presorted
    assert p_nat.max_terms == p_py.max_terms

    vn, in_ = bm25_topk_device(
        p_nat.doc_ids, p_nat.weights, idx.n_docs, 10,
        presorted=True, max_run=p_nat.max_terms,
    )
    vp, ip = bm25_topk_device(
        p_py.doc_ids, p_py.weights, idx.n_docs, 10,
        presorted=True, max_run=p_py.max_terms,
    )
    np.testing.assert_array_equal(np.asarray(in_), np.asarray(ip))
    np.testing.assert_allclose(np.asarray(vn), np.asarray(vp), rtol=1e-6)


def test_native_plan_candidate_sets_identical(lib, idx):
    rng = np.random.default_rng(53)
    term_ids = _queries(rng, 8, t=3)
    p_nat = build_query_plan(idx, term_ids, max_postings_per_term=32)
    p_py = build_query_plan(
        idx, term_ids, max_postings_per_term=32, use_native=False
    )
    for b in range(len(term_ids)):
        nat = {
            (int(d), round(float(w), 5))
            for d, w in zip(p_nat.doc_ids[b], p_nat.weights[b])
            if d < idx.n_docs
        }
        py = {
            (int(d), round(float(w), 5))
            for d, w in zip(p_py.doc_ids[b], p_py.weights[b])
            if d < idx.n_docs
        }
        assert nat == py


def test_native_plan_exact_recall(lib, idx):
    rng = np.random.default_rng(54)
    term_ids = _queries(rng, 12, hi=40)  # frequent (heavily pruned) terms
    plan = build_query_plan(idx, term_ids, max_postings_per_term=64)
    _, ids = bm25_topk_device(
        plan.doc_ids, plan.weights, idx.n_docs, 10,
        presorted=True, max_run=plan.max_terms,
    )
    recs = []
    for b, tids in enumerate(term_ids):
        _, ri = ref.bm25_topk(idx, tids, 10)
        exact = {int(x) for x in ri if x >= 0}
        got = {int(x) for x in np.asarray(ids)[b] if x >= 0}
        if exact:
            recs.append(len(exact & got) / len(exact))
    assert np.mean(recs) >= 0.99


def test_native_plan_edge_cases(lib, idx):
    # empty query, unknown terms, repeated terms (qtf weighting)
    term_ids = [[], [0, 0], [7, 7, 7], [idx.term_offsets.shape[0] + 99]]
    p_nat = build_query_plan(idx, term_ids, max_postings_per_term=64)
    p_py = build_query_plan(
        idx, term_ids, max_postings_per_term=64, use_native=False
    )
    vn, in_ = bm25_topk_device(
        p_nat.doc_ids, p_nat.weights, idx.n_docs, 5,
        presorted=True, max_run=p_nat.max_terms,
    )
    vp, ip = bm25_topk_device(
        p_py.doc_ids, p_py.weights, idx.n_docs, 5,
        presorted=True, max_run=p_py.max_terms,
    )
    np.testing.assert_array_equal(np.asarray(in_), np.asarray(ip))
    np.testing.assert_allclose(np.asarray(vn), np.asarray(vp), rtol=1e-6)
    assert (np.asarray(in_)[0] == -1).all()  # empty query ranks nothing


def _row_sets(out_ids, out_w, n_docs):
    return [
        {
            (int(d), round(float(w), 5))
            for d, w in zip(ri, rw)
            if d < n_docs
        }
        for ri, rw in zip(out_ids, out_w)
    ]


def test_bitmap_intersection_candidate_sets_identical(lib, idx):
    """Forcing membership bitmaps onto EVERY term (bitmap_min_df=1) must
    leave candidate sets bit-identical to the merge/gallop path and to the
    NumPy reference — the bitmap is an execution strategy for the pairwise
    intersections, never a semantics change. Exercises both the
    no-overflow fast path (ample budget) and the bounded-heap path (tiny
    multi budget), plus the filtered (doc_mask) plan."""
    rng = np.random.default_rng(55)
    term_ids = [list(rng.integers(1, 40, size=4)) for _ in range(12)]

    for budget in (256, 2):  # fast path / heap path
        nat = native.native_build_query_plan(
            idx, term_ids, max_postings_per_term=32, multi_budget=budget,
            n_threads=1,
        )
        bmp = native.native_build_query_plan(
            idx, term_ids, max_postings_per_term=32, multi_budget=budget,
            n_threads=1, bitmap_min_df=1,
        )
        assert nat is not None and bmp is not None
        assert _row_sets(bmp[0], bmp[1], idx.n_docs) == _row_sets(
            nat[0], nat[1], idx.n_docs
        )

    mask = np.zeros(idx.n_docs, dtype=bool)
    mask[::3] = True
    nat = native.native_build_query_plan(
        idx, term_ids, max_postings_per_term=32, multi_budget=64,
        n_threads=1, doc_mask=mask,
    )
    bmp = native.native_build_query_plan(
        idx, term_ids, max_postings_per_term=32, multi_budget=64,
        n_threads=1, doc_mask=mask, bitmap_min_df=1,
    )
    assert _row_sets(bmp[0], bmp[1], idx.n_docs) == _row_sets(
        nat[0], nat[1], idx.n_docs
    )


def test_bitmap_cache_bits_match_postings(idx):
    """bitmap_cache rows decode back to exactly each term's postings."""
    slots, words = idx.bitmap_cache(1)
    assert slots is not None
    for t in (1, 7, 39, 200):
        s = int(slots[t])
        assert s >= 0
        lo, hi = int(idx.term_offsets[t]), int(idx.term_offsets[t + 1])
        docs = np.flatnonzero(
            np.unpackbits(
                words[s].view(np.uint8), bitorder="little"
            )[: idx.n_docs]
        )
        np.testing.assert_array_equal(docs, np.sort(idx.doc_ids[lo:hi]))


def test_stale_or_broken_library_degrades_to_python(monkeypatch):
    """A library missing a symbol (stale prebuilt .so) must make _load return
    None — Python fallbacks take over — instead of crashing every import."""
    from openintel_tpu import native

    monkeypatch.setattr(native, "_lib", None)

    def bad_bind(lib):
        raise AttributeError("undefined symbol: plan_build")

    monkeypatch.setattr(native, "_bind", bad_bind)
    assert native._load() is None
    # and the query-plan builder falls back to the NumPy path
    assert native.native_build_query_plan(None, [], 8, 8) is None


def test_source_hash_mismatch_degrades_to_python(monkeypatch):
    """A prebuilt .so whose symbols all resolve but whose embedded source
    hash no longer matches the on-disk .cpp sources must NOT be trusted —
    it could silently serve older planner semantics (advisor finding r3).
    _load must degrade to the Python path until an explicit build()."""
    from openintel_tpu import native

    if not native._SO.exists():  # pragma: no cover - toolchain-less host
        import pytest

        pytest.skip("native library not built")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_src_hash", lambda: "different-hash")
    assert native._load() is None


def test_build_rebuilds_newer_mtime_stale_hash_library(tmp_path, monkeypatch):
    """A .so whose mtime is NEWER than the sources but whose embedded hash
    does not match them (mtimes lie across git operations and copies) must
    be rebuilt by build(), not skipped — otherwise _load refuses the stamp
    and the Python fallback serves forever with no path back to native."""
    import ctypes
    import shutil

    from openintel_tpu import native

    if not native._SO.exists():  # pragma: no cover - toolchain-less host
        import pytest

        pytest.skip("native library not built")
    # stage the real sources + a hash-stale .so with a newer mtime
    srcs = [tmp_path / s.name for s in native._SRCS]
    for src, dst in zip(native._SRCS, srcs):
        shutil.copy(src, dst)
    so = tmp_path / native._SO.name
    monkeypatch.setattr(native, "_SRCS", srcs)
    monkeypatch.setattr(native, "_SO", so)
    monkeypatch.setattr(native, "_lib", None)
    native.build()  # genuine build of the staged sources
    # make the sources differ from what the .so was built from, then give
    # the .so the newest mtime (the lying-mtime scenario)
    with open(srcs[-1], "a") as f:
        f.write("\n// drift\n")
    import os

    newest = max(s.stat().st_mtime for s in srcs) + 10
    os.utime(so, (newest, newest))
    native.build()  # must detect the stale stamp and rebuild
    lib = ctypes.CDLL(str(so))
    lib.openintel_src_hash.restype = ctypes.c_char_p
    assert lib.openintel_src_hash().decode("ascii") == native._src_hash()


def test_built_library_carries_matching_source_hash():
    """build() stamps the current source hash into the .so and _load
    accepts it (fresh library loads; only a stale one is refused). Loads
    through _load() — the serving path — which dlopens the content-
    addressed alias; the canonical pathname may be pinned to an older
    image in this very process (dlopen name-caching, see _so_unique)."""
    from openintel_tpu import native

    native.build()
    lib = native._load()
    assert lib is not None
    assert lib.openintel_src_hash().decode("ascii") == native._src_hash()


def test_native_plan_zero_budget_matches_reference():
    """max_postings_per_term=0 is a legal budget (terms contribute only
    forced multi-term docs), not a disable switch — the native planner must
    produce the identical candidate set to the NumPy reference (review
    finding: the C++ path previously emitted FULL postings at max_m=0)."""
    from openintel_tpu.index.build import build_postings_index
    from openintel_tpu.ops.bm25 import build_query_plan, encode_query

    texts = [
        f"alpha beta gamma doc{i} " + ("common " * 3) for i in range(40)
    ]
    idx = build_postings_index(texts)
    qs = [encode_query(idx, "alpha common gamma"), encode_query(idx, "beta")]
    plans = {}
    for use_native in (True, False):
        p = build_query_plan(
            idx, qs, max_postings_per_term=0, multi_budget=8,
            use_native=use_native,
        )
        rows = []
        for r_ids, r_w in zip(p.doc_ids, p.weights):
            real = r_ids < idx.n_docs
            rows.append(sorted(zip(r_ids[real].tolist(), r_w[real].tolist())))
        plans[use_native] = rows
    assert plans[True] == plans[False]


# --------------------------- masked (filtered) plans


def test_native_masked_plan_candidate_sets_identical(lib, idx):
    """plan_build_masked == the NumPy mask-aware reference: identical
    (doc, weight) candidate sets under a random half-corpus mask."""
    rng = np.random.default_rng(57)
    term_ids = _queries(rng, 12)
    mask = rng.random(idx.n_docs) < 0.5
    p_nat = build_query_plan(
        idx, term_ids, max_postings_per_term=64, doc_mask=mask
    )
    p_py = build_query_plan(
        idx, term_ids, max_postings_per_term=64, doc_mask=mask,
        use_native=False,
    )
    assert p_nat.presorted and p_py.presorted
    for b in range(len(term_ids)):
        nat = {
            (int(d), round(float(w), 5))
            for d, w in zip(p_nat.doc_ids[b], p_nat.weights[b])
            if d < idx.n_docs
        }
        py = {
            (int(d), round(float(w), 5))
            for d, w in zip(p_py.doc_ids[b], p_py.weights[b])
            if d < idx.n_docs
        }
        assert nat == py
        assert all(mask[d] for d, _ in nat)  # no masked doc leaks


def test_native_masked_plan_device_results_match(lib, idx):
    """End to end: masked native plans produce the same device top-k as
    masked NumPy plans, including a tiny include-list (extreme
    selectivity, pruning + multi-term forcing fully masked)."""
    rng = np.random.default_rng(58)
    term_ids = _queries(rng, 8)
    for mask in (
        rng.random(idx.n_docs) < 0.2,
        np.isin(np.arange(idx.n_docs), rng.integers(0, idx.n_docs, 25)),
    ):
        p_nat = build_query_plan(
            idx, term_ids, max_postings_per_term=48, doc_mask=mask
        )
        p_py = build_query_plan(
            idx, term_ids, max_postings_per_term=48, doc_mask=mask,
            use_native=False,
        )
        vn, in_ = bm25_topk_device(
            p_nat.doc_ids, p_nat.weights, idx.n_docs, 10,
            presorted=True, max_run=p_nat.max_terms,
        )
        vp, ip = bm25_topk_device(
            p_py.doc_ids, p_py.weights, idx.n_docs, 10,
            presorted=True, max_run=p_py.max_terms,
        )
        np.testing.assert_array_equal(np.asarray(in_), np.asarray(ip))
        np.testing.assert_allclose(np.asarray(vn), np.asarray(vp), rtol=1e-6)


def test_native_masked_plan_matches_oracle(lib, idx):
    """Masked native plans reproduce the full-scan filtered oracle top-k
    exactly (pruned exactness holds on the filtered corpus)."""
    rng = np.random.default_rng(59)
    term_ids = _queries(rng, 6)
    mask = rng.random(idx.n_docs) < 0.3
    p = build_query_plan(idx, term_ids, max_postings_per_term=64, doc_mask=mask)
    vals, ids = bm25_topk_device(
        p.doc_ids, p.weights, idx.n_docs, 10,
        presorted=True, max_run=p.max_terms,
    )
    ids = np.asarray(ids)
    vals = np.asarray(vals)
    for b, terms in enumerate(term_ids):
        rv, ri = ref.bm25_topk(idx, terms, 10, doc_mask=mask)
        np.testing.assert_array_equal(ids[b], ri)
        np.testing.assert_allclose(vals[b], rv, rtol=1e-5, atol=1e-6)


# --------------------------- the port's multi-term grouping


# case -> (terms a query, max_m, multi_budget, index variant, kept share of a
# doc mask or None)
GROUPING_CASES = {
    "9-terms": (9, 32, 16, "plain", None),  # 36 pairwise runs
    "12-terms": (12, 32, 16, "plain", None),  # 66 runs
    "small-budget": (4, 16, 2, "plain", None),  # nearly every query groups
    "tied-impacts": (5, 32, 16, "tied", None),  # equal scores at the edge
    "mask-50": (6, 32, 16, "plain", 0.5),
    "mask-5": (6, 32, 16, "plain", 0.05),
    "wide-doc-ids": (9, 32, 16, "wide", None),  # 31-bit doc ids
}


@pytest.fixture(scope="module")
def port_lib():
    tnative.build()
    if tnative._load() is None:  # pragma: no cover - toolchain always present
        pytest.skip("native library unavailable")
    return True


def _variant(idx, kind):
    """``idx`` itself, or a copy with every impact 1.0 (docs matching the
    same terms tie), or with doc d renumbered d * 2**16 + a random offset
    below 2**16 (ascending as before, ids spread over 31 bits, so every
    radix digit of the grouping is in use)."""
    if kind == "plain":
        return idx
    if kind == "tied":
        return dataclasses.replace(
            idx, impact=np.ones_like(idx.impact), impact_order=None,
            _pruned_cache=None, _bitmap_cache=None,
        )
    off = np.random.default_rng(61).integers(0, 1 << 16, size=idx.n_docs)
    wide = (idx.doc_ids.astype(np.int64) << 16) + off[idx.doc_ids]
    return dataclasses.replace(
        idx, doc_ids=wide.astype(np.int32), n_docs=idx.n_docs << 16,
        impact_order=None, _pruned_cache=None, _bitmap_cache=None,
    )


def _grouped_counts(idx, term_ids, max_m, budget):
    """(queries, hits) that the planner groups by doc, counted here: a query
    of >= 2 distinct terms, one of them longer than ``max_m``, whose
    pairwise intersections give more than 2 * ``budget`` hits (one a side)."""
    n_vocab = idx.term_offsets.shape[0] - 1
    queries = hits = 0
    for q in term_ids:
        terms = list(dict.fromkeys(int(t) for t in q if 0 < t < n_vocab))
        lists = [idx.doc_ids[idx.term_offsets[t] : idx.term_offsets[t + 1]] for t in terms]
        if len(lists) < 2 or max(len(x) for x in lists) <= max_m:
            continue
        n = sum(
            2 * np.intersect1d(lists[i], lists[j], assume_unique=True).size
            for i in range(len(lists))
            for j in range(i + 1, len(lists))
        )
        if n > 2 * budget:
            queries += 1
            hits += n
    return queries, hits


@pytest.mark.parametrize("case", list(GROUPING_CASES))
def test_port_grouping_plans_match_reference(lib, port_lib, idx, case, monkeypatch):
    """The port's planner, whose multi-term selection groups the pairwise
    hits by (doc, key) with one radix sort, gives the reference planner's
    plans element for element: many-term queries (the reference's k-way
    scan and its sort beyond 64 runs), a budget most queries outgrow, ties
    at the budget's edge, filtered plans and doc ids over 31 bits. The
    ``planner`` span's ``multi_queries`` and ``multi_hits`` equal the
    counts made here from the same queries."""
    n_terms, max_m, budget, kind, keep = GROUPING_CASES[case]
    jidx = _variant(idx, kind)
    port_idx = convert.postings_index(jidx)
    rng = np.random.default_rng(sorted(GROUPING_CASES).index(case) + 60)
    term_ids = [list(rng.integers(1, 120, size=n_terms)) for _ in range(64)]
    mask = None if keep is None else rng.random(jidx.n_docs) < keep
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    got = tnative.native_build_query_plan(
        port_idx, term_ids, max_m, budget, n_threads=3, doc_mask=mask
    )
    want = native.native_build_query_plan(jidx, term_ids, max_m, budget, doc_mask=mask)
    assert got is not None and want is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    (planner,) = [r for r in rec.records() if r.name == "planner"]
    queries, hits = _grouped_counts(jidx, term_ids, max_m, budget)
    assert (planner.attrs["multi_queries"], planner.attrs["multi_hits"]) == (queries, hits)
    assert queries > len(term_ids) // 2
