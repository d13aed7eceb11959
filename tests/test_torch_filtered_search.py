"""Port parity for filtered search: openintel_tpu_torch against the JAX
package, on the CPU.

Every test of ``tests/test_filtered_search.py`` has its counterpart here,
with each of its parametrised kernels. The same index, seeded queries and
masks go through the JAX retrievers (Pallas in interpret mode) and the
port's (plain twins on CPU tensors), at 20,000 docs (two int8 supers, the
last one short) and D = 64. Beside them: the rank compaction and the
masked scans against the JAX functions, the copied pure-NumPy helpers
against the originals, an over-fetch beyond kernel A's capacity, and both
fusions.

Tolerance, ``tests/test_torch_retriever.py``'s near-tie rule: fused scores
agree to 1e-5; ids are equal except inside clusters of scores within
1e-5, where the id sets agree. ``kernel="fast"`` runs on dyadic rows and
queries (``torch_dense_utils``), so its quantised scores do not depend on
the sum order.
"""

import ml_dtypes
import numpy as np
import pytest
import torch
from ranking_utils import assert_ranking_close
from torch_dense_utils import dyadic_rows

from openintel_tpu.index.schema import DenseIndex
from openintel_tpu.index.synthetic import (
    synthetic_embeddings,
    synthetic_postings_index,
    synthetic_query_embeddings,
)
from openintel_tpu.models import retrievers as jr
from openintel_tpu.ops import dense as jdense
from openintel_tpu.ops import fusion as jfusion
from openintel_tpu_torch import convert
from openintel_tpu_torch.models import retrievers as tr
from openintel_tpu_torch.ops import dense as tdense
from openintel_tpu_torch.ops import fusion as tfusion

TOL = 1e-5
N = 20_000
DIM = 64
K, C = 10, 20
NQ = 12  # sub-batches of 8: one full, one padded
STORES = {"xla": "bf16", "int8": "bf16", "pallas": "f32", "fast": "bf16", "int4": "bf16"}
KEEP = [3, 50, 111, 222, 333, 444, 555]  # a 7-doc include-list: starves k = 10


def _assert_close(got, want):
    assert got.ids.shape == want.ids.shape and got.ids.dtype == np.int32
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=TOL)
    assert_ranking_close(got.scores, got.ids, want.scores, want.ids, rtol=0, atol=TOL)


def _mask(p, seed=7):
    return np.random.default_rng(seed).random(N) < p


def _three_masks():
    rng = np.random.default_rng(53)
    return np.stack([rng.random(N) < p for p in (0.5, 0.25, 0.75)])


@pytest.fixture(scope="module")
def corpus():
    index = synthetic_postings_index(N, vocab_size=2_000, seed=3)
    emb = synthetic_embeddings(N, dim=DIM, seed=4)
    rng = np.random.default_rng(5)
    ranks = np.exp(rng.uniform(np.log(20), np.log(1_999), size=(NQ, 3)))
    term_ids = [list(r + 1) for r in ranks.astype(np.int64)]
    term_ids[4] = []  # a query with no known terms
    q, _ = synthetic_query_embeddings(emb, NQ, seed=6)
    rng = np.random.default_rng(8)
    dyadic = (dyadic_rows(rng, N, DIM), dyadic_rows(rng, NQ, DIM))
    texts = ["t21 t40 t77", "t30", "t1999 t25 t25", "nothing known", "t22 t23"]
    return index, emb, term_ids, q, dyadic, texts


@pytest.fixture(scope="module")
def pair(corpus):
    """``pair(kernel, fusion, device_batch)``: the JAX and the port hybrid
    retriever over the same index, built once per configuration (building
    the JAX retriever dominates)."""
    index, emb, _, _, (rows, _), _ = corpus
    built = {}

    def get(kernel, fusion="zblend", device_batch=8):
        key = (kernel, fusion, device_batch)
        if key not in built:
            dtype = ml_dtypes.bfloat16 if STORES[kernel] == "bf16" else np.float32
            if kernel == "fast":  # as they are: normalising would make them non-dyadic
                dense = DenseIndex(embeddings=rows.astype(dtype), n_docs=N, dim=DIM)
            else:
                dense = DenseIndex.from_embeddings(emb, dtype=dtype)
            j = jr.HybridRetriever(
                index, dense, kernel=kernel, fusion=fusion, device_batch=device_batch
            )
            t = tr.HybridRetriever(
                convert.postings_index(index), convert.dense_index_from(dense),
                kernel=kernel, fusion=fusion, device_batch=device_batch, device="cpu",
            )
            built[key] = (j, t)
        return built[key]

    return get


def _queries(corpus, kernel):
    _, _, term_ids, q, (_, dq), _ = corpus
    return term_ids, (dq if kernel == "fast" else q)


def _search_both(corpus, pair, kernel, fusion="zblend", device_batch=8, **filters):
    j, t = pair(kernel, fusion, device_batch)
    term_ids, q = _queries(corpus, kernel)
    kw = {"k": K, "candidates_per_arm": C, **filters}
    return t.search_prepared(term_ids, q, **kw), j.search_prepared(term_ids, q, **kw)


def _result(vals, ids):
    return tr.SearchResult(ids=np.asarray(ids), scores=np.asarray(vals))


def _assert_no_masked(res, mask):
    real = res.ids >= 0
    assert mask[res.ids[real]].all()


# ---------------------------------------------------------------- helpers


@pytest.mark.parametrize(
    "kwargs",
    [
        {"exclude_ids": [0, 2, 4]},
        {"include_ids": [1, 3, 5], "exclude_ids": [3]},
        {"include_ids": []},
        {},
        {"include_ids": [10]},
        {"exclude_ids": [-1]},
        {"include_ids": [1.5]},
        {"exclude_ids": 3},
    ],
)
def test_make_filter_mask_equals_the_original(kwargs):
    """The copy builds the same masks and raises the same errors."""
    try:
        want = jr.make_filter_mask(10, **kwargs)
    except (TypeError, ValueError) as e:
        with pytest.raises(type(e)) as got:
            tr.make_filter_mask(10, **kwargs)
        assert str(got.value) == str(e)
        return
    got = tr.make_filter_mask(10, **kwargs)
    assert got.dtype == np.bool_ and got.shape == (10,)
    np.testing.assert_array_equal(got, want)


def test_make_filter_mask_cases():
    m = tr.make_filter_mask(10, exclude_ids=[0, 2, 4])
    assert not m[[0, 2, 4]].any() and m.sum() == 7
    m = tr.make_filter_mask(10, include_ids=[1, 3, 5], exclude_ids=[3])
    assert set(np.flatnonzero(m).tolist()) == {1, 5}
    with pytest.raises(ValueError, match="include_ids out of range"):
        tr.make_filter_mask(10, include_ids=[10])
    with pytest.raises(ValueError, match="exclude_ids out of range"):
        tr.make_filter_mask(10, exclude_ids=[-1])


def test_filtered_fetch_width_equals_the_original():
    assert tr.FILTER_FETCH_CAP == jr.FILTER_FETCH_CAP
    for c in (1, 10, 20, 32, 100, 600, 2_000):
        for n in (30, 500, 1_000, 10_000, 1_250_000):
            for n_unmasked in sorted({0, 1, 7, n // 100, n // 10, n // 2, n}):
                assert tr.filtered_fetch_width(c, n, n_unmasked) == jr.filtered_fetch_width(
                    c, n, n_unmasked
                ), (c, n, n_unmasked)
    # the reference's own cases
    assert tr.filtered_fetch_width(10, 1000, 1000) == 64
    assert tr.filtered_fetch_width(10, 1000, 100) == 128
    assert tr.filtered_fetch_width(10, 10_000, 10) == tr.FILTER_FETCH_CAP
    assert tr.filtered_fetch_width(10, 1000, 10) == 1000
    assert tr.filtered_fetch_width(10, 500, 0) == 10
    assert tr.filtered_fetch_width(2000, 10_000, 10_000) == tr.FILTER_FETCH_CAP


_MASKS3 = np.random.default_rng(1).random((3, 12)) < 0.5


@pytest.mark.parametrize(
    "mask,group,b",
    [
        (_MASKS3[0], None, 2),
        (_MASKS3, [0, 2], 2),
        (_MASKS3[:1], None, 2),
        (np.ones(12, np.int32), None, 1),  # not bool
        (np.ones(13, bool), None, 1),  # 1-D, wrong length
        (_MASKS3[0], [0, 0], 2),  # a group with a 1-D mask
        (_MASKS3, None, 2),  # groups required
        (_MASKS3, [0], 2),  # one group short
        (_MASKS3, [0, 3], 2),  # out of range
        (_MASKS3, [-1, 0], 2),
        (_MASKS3, [0.9, 1.2], 2),  # float groups
        (_MASKS3[:, :11], [0], 1),  # (G, n) of the wrong width
        (np.ones((0, 12), bool), [0], 1),  # no rows
        (np.ones((2, 3, 12), bool), [0], 1),
    ],
)
def test_group_masks_equal_the_original(mask, group, b):
    """``_as_group_masks`` and ``_as_doc_mask``: the same arrays, or the
    same error type and message."""
    for name, args in (("_as_group_masks", (mask, group, 12, b)), ("_as_doc_mask", (mask, 12))):
        try:
            want = getattr(jr, name)(*args)
        except (TypeError, ValueError) as e:
            with pytest.raises(type(e)) as got:
                getattr(tr, name)(*args)
            assert str(got.value) == str(e)
            continue
        got = getattr(tr, name)(*args)
        if name == "_as_doc_mask":
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_group_masks_overflow_check():
    """The int32 flat-index bound of the reference, kept: G x n_docs >= 2**31
    raises (checked on a broadcast view, nothing that size is made)."""
    n = 2**30
    masks = np.broadcast_to(np.ones(1, bool), (2, n))
    for mod in (jr, tr):
        with pytest.raises(ValueError, match="overflows the int32"):
            mod._as_group_masks(masks, [0, 1], n, 2)


def test_run_per_group_equals_the_original():
    groups = np.array([2, 0, 2, 1, 0, 2], np.int32)

    def fn(g, rows):
        return (rows[:, None] * 0.5 + g).repeat(3, 1), (rows[:, None] + 10 * g).repeat(3, 1)

    for got, want in zip(tr.run_per_group(groups, 3, fn), jr.run_per_group(groups, 3, fn)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_grouped_query_plan_equals_the_original(corpus):
    """Array for array, pruned and unpruned, with an all-True row, an
    empty row and a group that holds no query."""
    index, _, term_ids, _, _, _ = corpus
    tindex = convert.postings_index(index)
    masks = np.stack([_mask(0.5), np.ones(N, bool), _mask(0.01, seed=9), np.zeros(N, bool)])
    groups = np.array([0, 1, 2, 0, 1, 2, 3, 0, 0, 1, 3, 2], np.int32)
    for prune in (None, 128):
        want = jr.grouped_query_plan(
            index, term_ids, masks, groups, max_postings_per_term=prune, multi_budget=256
        )
        got = tr.grouped_query_plan(
            tindex, term_ids, masks, groups, max_postings_per_term=prune, multi_budget=256
        )
        np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
        np.testing.assert_array_equal(got.weights, want.weights)
        assert (got.n_docs, got.presorted, got.max_terms) == (
            want.n_docs, want.presorted, want.max_terms
        )


# ------------------------------------------------------- compaction and scans


@pytest.mark.parametrize("cw,c", [(64, 20), (20, 20), (12, 20)])  # cw < c pads
def test_mask_compact_ranked_matches_jax(cw, c):
    rng = np.random.default_rng(cw)
    ids = rng.integers(0, 1_000, size=(6, cw)).astype(np.int32)
    ids[1, cw // 2 :] = -1  # a short ranking
    vals = np.sort(rng.standard_normal((6, cw)).astype(np.float32), axis=1)[:, ::-1].copy()
    keep = rng.random((6, cw)) < 0.4
    keep[2] = False  # nothing survives
    keep[3] = True  # everything survives
    keep[1] &= ids[1] >= 0
    want_ids, want_surv = jfusion.mask_compact_ranked(ids, keep, c)
    got_ids, got_surv = tfusion.mask_compact_ranked(
        torch.from_numpy(ids), torch.from_numpy(keep), c
    )
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_surv.numpy(), np.asarray(want_surv))
    assert got_surv.dtype == torch.int32 and got_ids.shape == (6, c)
    wv, wi, ws = jfusion.mask_compact_ranked_vals(ids, vals, keep, c)
    gv, gi, gs = tfusion.mask_compact_ranked_vals(
        torch.from_numpy(ids), torch.from_numpy(vals), torch.from_numpy(keep), c
    )
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))  # -inf padding too
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize(
    "mask_kind,k", [("half", 10), ("few", 10), ("empty", 10), ("half", 40_000), ("all", 32)]
)
def test_masked_scans_match_jax(corpus, mask_kind, k):
    """``dense_topk_xla_masked`` on the rows and ``dense_topk_masked_t`` on
    kernel D's padded row-major corpus, against the JAX functions on the
    rows and on their transposed padded copy: k > survivors, an empty mask
    and k > n_docs pad with (0.0, -1)."""
    _, emb, _, q, _, _ = corpus
    mask = {
        "half": _mask(0.5),
        "few": tr.make_filter_mask(N, include_ids=KEEP),
        "empty": np.zeros(N, bool),
        "all": np.ones(N, bool),
    }[mask_kind]
    want = jdense.dense_topk_xla_masked(emb, q, mask, k)
    got = tdense.dense_topk_xla_masked(
        torch.from_numpy(emb), torch.from_numpy(q), torch.from_numpy(mask), k
    )
    n_pad = 2 * 16_384
    emb_t = np.zeros((DIM, n_pad), np.float32)
    emb_t[:, :N] = emb.T
    want_t = jdense.dense_topk_masked_t(emb_t, q, mask, k, n_docs=N)
    fast_rows = convert.fast_corpus(torch.from_numpy(emb))
    assert fast_rows.shape == (n_pad, DIM)
    got_t = tdense.dense_topk_masked_t(
        fast_rows, torch.from_numpy(q), torch.from_numpy(mask), k, n_docs=N
    )
    for (gv, gi), (wv, wi) in ((got, want), (got_t, want_t)):
        wv, wi = np.asarray(wv), np.asarray(wi)
        assert gi.shape == wi.shape == (NQ, min(k, N)) and gi.dtype == torch.int32
        _assert_close(_result(gv, gi), _result(wv, wi))
        real = gi.numpy() >= 0
        assert mask[gi.numpy()[real]].all()
        assert real.sum(axis=1).tolist() == [min(k, int(mask.sum()))] * NQ


def test_masked_scan_reads_padded_feature_columns_at_the_query_width(corpus):
    """Rows zero-padded to more feature columns than the queries (kernel
    B's rows at D = 100 -> 112) give the unpadded rows' result."""
    rng = np.random.default_rng(11)
    rows = torch.from_numpy(dyadic_rows(rng, 3_000, 100))
    q = torch.from_numpy(dyadic_rows(rng, 5, 100))
    mask = torch.from_numpy(rng.random(3_000) < 0.3)
    want = tdense.dense_topk_xla_masked(rows, q, mask, 10)
    got = tdense.dense_topk_xla_masked(convert.fused_corpus(rows), q, mask, 10)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------- BM25 arm


def test_filter_mask_validation(corpus):
    index = corpus[0]
    r = tr.BM25Retriever(convert.postings_index(index), device="cpu")
    with pytest.raises(TypeError, match="bool"):
        r.search(["a"], filter_mask=np.ones(N, np.int32))
    with pytest.raises(ValueError, match="shape"):
        r.search(["a"], filter_mask=np.ones(N + 1, bool))


@pytest.mark.parametrize("p", [0.5, 0.01])
def test_bm25_filtered_matches_jax(corpus, p):
    index, texts = corpus[0], corpus[5]
    mask = _mask(p)
    want = jr.BM25Retriever(index).search(texts, k=K, filter_mask=mask)
    got = tr.BM25Retriever(convert.postings_index(index), device="cpu").search(
        texts, k=K, filter_mask=mask
    )
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)
    _assert_no_masked(got, mask)


def test_bm25_filtered_keeps_full_corpus_idf(corpus):
    """The filter restricts candidates and never re-weights: each surviving
    doc keeps its unfiltered score."""
    index, texts = corpus[0], corpus[5]
    r = tr.BM25Retriever(convert.postings_index(index), device="cpu")
    full = r.search(texts, k=200)
    filt = r.search(texts, k=K, filter_mask=_mask(0.5))
    for b in range(len(texts)):
        full_scores = dict(zip(full.ids[b].tolist(), full.scores[b].tolist()))
        for i, s in zip(filt.ids[b], filt.scores[b]):
            if i >= 0 and int(i) in full_scores:
                np.testing.assert_allclose(s, full_scores[int(i)], rtol=1e-6)


# ---------------------------------------------------------------- dense arm


@pytest.mark.parametrize("kernel", ["xla", "pallas", "int8", "int4", "fast"])
def test_dense_filtered_matches_jax(corpus, pair, kernel):
    """The exact masked scan over each arm's resident rows (the stored rows
    for int8/int4, kernel D's padded corpus for fast, kernel B's
    feature-padded rows for pallas) equals the JAX retriever's."""
    j, t = pair(kernel)
    _, q = _queries(corpus, kernel)
    mask = _mask(0.5)
    want = j.dense.search_embeddings(q, K, filter_mask=mask)
    got = t.dense.search_embeddings(q, K, filter_mask=mask)
    _assert_close(got, want)
    _assert_no_masked(got, mask)


@pytest.mark.parametrize("kernel", ["xla", "int8"])
def test_dense_grouped_matches_per_mask(corpus, pair, kernel):
    j, t = pair(kernel)
    _, q = _queries(corpus, kernel)
    masks, groups = _three_masks(), np.arange(NQ, dtype=np.int32) % 3
    got = t.dense.search_embeddings(q, K, filter_mask=masks, filter_group=groups)
    _assert_close(got, j.dense.search_embeddings(q, K, filter_mask=masks, filter_group=groups))
    for b in range(NQ):
        want = t.dense.search_embeddings(q[b : b + 1], K, filter_mask=masks[groups[b]])
        np.testing.assert_array_equal(got.ids[b], want.ids[0])
        np.testing.assert_allclose(got.scores[b], want.scores[0], rtol=0, atol=TOL)


# ---------------------------------------------------------------- hybrid


@pytest.mark.parametrize("fusion", ["zblend", "rrf"])
@pytest.mark.parametrize("kernel", ["xla", "pallas", "int8", "fast", "int4"])
def test_hybrid_filtered_matches_jax(corpus, pair, kernel, fusion):
    """The filtered step (over-fetch, rank compaction, mask-aware BM25
    plan, fusion) at 50 %: 12 queries in sub-batches of 8."""
    mask = _mask(0.5)
    got, want = _search_both(corpus, pair, kernel, fusion, filter_mask=mask)
    _assert_close(got, want)
    _assert_no_masked(got, mask)


@pytest.mark.parametrize("p", [0.1, 0.01])
def test_hybrid_selectivities_match_jax(corpus, pair, p):
    """int8 at 10 % (c_fetch 256) and 1 % (c_fetch 1,024, beyond kernel
    A's 512 candidates on two supers: the pool clamps, pads and starves,
    so the fallback serves)."""
    j, t = pair("int8")
    term_ids, q = _queries(corpus, "int8")
    mask = _mask(p)
    prep = t.prepare(term_ids, q, k=K, candidates_per_arm=C, filter_mask=mask)
    assert prep.c_fetch == tr.filtered_fetch_width(C, N, int(mask.sum()))
    assert prep.c_fetch == (1024 if p == 0.01 else 256)
    vals, ids, surv = t.run_prepared_device(prep)
    assert surv.shape == (2, 8) and surv.dtype == torch.int32
    if p == 0.01:  # the pool holds at most 512 of the 20,000 docs
        assert (surv.flatten()[:NQ] < C).any()
    got, want = _search_both(corpus, pair, "int8", filter_mask=mask)
    _assert_close(got, want)
    _assert_no_masked(got, mask)


@pytest.mark.parametrize("fusion", ["zblend", "rrf"])
@pytest.mark.parametrize("kernel", ["xla", "int8"])
def test_hybrid_starvation_fallback_exact(corpus, pair, kernel, fusion):
    """7 unmasked docs and k = 10: every pool starves and the exact masked
    fallback serves each query, as the JAX retriever's does."""
    mask = tr.make_filter_mask(N, include_ids=KEEP)
    _, t = pair(kernel, fusion)
    calls = []
    fallback = t._filtered_fallback

    def spy(prep, rows):
        calls.append(rows.copy())
        return fallback(prep, rows)

    t._filtered_fallback = spy
    try:
        got, want = _search_both(corpus, pair, kernel, fusion, filter_mask=mask)
    finally:
        del t._filtered_fallback
    assert len(calls) == 1 and calls[0].tolist() == list(range(NQ))
    _assert_close(got, want)
    _assert_no_masked(got, mask)


def test_hybrid_filtered_multibatch_matches_single(corpus, pair):
    """Sub-batches of 8 and 5 with padding rows equal one batch of 12."""
    mask = _mask(0.5, seed=31)
    term_ids, q = _queries(corpus, "xla")
    kw = {"k": K, "candidates_per_arm": C, "filter_mask": mask}
    want = pair("xla", device_batch=NQ)[1].search_prepared(term_ids, q, **kw)
    for db in (8, 5):
        got = pair("xla", device_batch=db)[1].search_prepared(term_ids, q, **kw)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=TOL)
    _assert_close(want, pair("xla", device_batch=5)[0].search_prepared(term_ids, q, **kw))


def test_hybrid_empty_mask_returns_padding(corpus, pair):
    _, t = pair("xla")
    term_ids, q = _queries(corpus, "xla")
    res = t.search_prepared(term_ids[:2], q[:2], k=5, filter_mask=np.zeros(N, bool))
    np.testing.assert_array_equal(res.ids, -np.ones((2, 5), np.int32))
    np.testing.assert_array_equal(res.scores, np.zeros((2, 5), np.float32))


@pytest.mark.parametrize("kernel", ["xla", "int8"])
def test_hybrid_unfiltered_path_unchanged(corpus, pair, kernel):
    """filter_mask=None runs the unfiltered step: no filtered operands, two
    outputs, and the same results as a search that never names a filter."""
    _, t = pair(kernel)
    term_ids, q = _queries(corpus, kernel)
    prep = t.prepare(term_ids, q, k=K, candidates_per_arm=C, filter_mask=None)
    assert prep.filter_mask is None and prep.c_fetch == 0
    out = t.run_prepared_device(prep)
    assert len(out) == 2
    a = t.search_prepared(term_ids, q, k=K, candidates_per_arm=C)
    b = t.search_prepared(term_ids, q, k=K, candidates_per_arm=C, filter_mask=None)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    c = t.finalize_prepared(prep, out)
    np.testing.assert_array_equal(a.ids, c.ids)
    np.testing.assert_array_equal(a.scores, c.scores)


# ------------------------------------------- per-query filters (mask groups)


def test_group_masks_validation(corpus, pair):
    _, t = pair("xla")
    masks = _three_masks()
    with pytest.raises(ValueError, match="filter_group requires"):
        t.search(["a", "b"], filter_mask=masks[0], filter_group=[0, 0])
    with pytest.raises(ValueError, match="filter_group .*required"):
        t.search(["a", "b"], filter_mask=masks)
    with pytest.raises(ValueError, match="length"):
        t.search(["a", "b"], filter_mask=masks, filter_group=[0])
    with pytest.raises(ValueError, match="out of range"):
        t.search(["a", "b"], filter_mask=masks, filter_group=[0, 3])
    with pytest.raises(ValueError, match="requires filter_mask"):
        t.search(["a", "b"], filter_group=[0, 0])
    with pytest.raises(ValueError, match="!= \\(G >= 1"):
        t.search(["a"], filter_mask=masks[:, : N - 1], filter_group=[0])


def test_grouped_single_row_equals_batch_mask(corpus, pair):
    _, t = pair("xla")
    term_ids, q = _queries(corpus, "xla")
    mask = _mask(0.5)
    kw = {"k": K, "candidates_per_arm": C}
    a = t.search_prepared(term_ids, q, filter_mask=mask, **kw)
    b = t.search_prepared(term_ids, q, filter_mask=mask[None, :], **kw)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)


def test_bm25_grouped_matches_per_mask(corpus):
    index, texts = corpus[0], corpus[5]
    masks, groups = _three_masks(), np.arange(len(texts), dtype=np.int32) % 3
    r = tr.BM25Retriever(convert.postings_index(index), device="cpu")
    got = r.search(texts, k=K, filter_mask=masks, filter_group=groups)
    want_jax = jr.BM25Retriever(index).search(texts, k=K, filter_mask=masks, filter_group=groups)
    np.testing.assert_array_equal(got.ids, want_jax.ids)
    np.testing.assert_array_equal(got.scores, want_jax.scores)
    for b, text in enumerate(texts):
        want = r.search([text], k=K, filter_mask=masks[groups[b]])
        np.testing.assert_array_equal(got.ids[b], want.ids[0])
        np.testing.assert_allclose(got.scores[b], want.scores[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel", ["xla", "int8"])
def test_hybrid_grouped_matches_per_mask(corpus, pair, kernel):
    """One grouped batch of 3 masks equals the JAX retriever's, and each
    query equals a single-mask search of its own row."""
    masks, groups = _three_masks(), np.arange(NQ, dtype=np.int32) % 3
    got, want = _search_both(corpus, pair, kernel, filter_mask=masks, filter_group=groups)
    _assert_close(got, want)
    _, t = pair(kernel)
    term_ids, q = _queries(corpus, kernel)
    for b in range(NQ):
        one = t.search_prepared(
            [term_ids[b]], q[b : b + 1], k=K, candidates_per_arm=C,
            filter_mask=masks[groups[b]],
        )
        assert_ranking_close(got.scores[b], got.ids[b], one.scores[0], one.ids[0], rtol=0, atol=TOL)


def test_hybrid_grouped_mixed_starvation(corpus, pair):
    """A half-corpus group and a starving include-list group in one batch:
    the fallback serves the second group's rows only."""
    masks = np.stack([_mask(0.5), tr.make_filter_mask(N, include_ids=KEEP)])
    groups = np.arange(NQ, dtype=np.int32) % 2
    got, want = _search_both(corpus, pair, "xla", filter_mask=masks, filter_group=groups)
    _assert_close(got, want)
    _, t = pair("xla")
    term_ids, q = _queries(corpus, "xla")
    prep = t.prepare(term_ids, q, k=K, candidates_per_arm=C, filter_mask=masks, filter_group=groups)
    assert prep.n_unmasked == len(KEEP) and prep.c_fetch == 1024
    surv = t.run_prepared_device(prep)[2].flatten()[:NQ].numpy()
    assert (surv[1::2] < C).all() and (surv[::2] >= C).all()
    for b in range(NQ):
        one = t.search_prepared(
            [term_ids[b]], q[b : b + 1], k=K, candidates_per_arm=C,
            filter_mask=masks[groups[b]],
        )
        np.testing.assert_array_equal(got.ids[b], one.ids[0])
        np.testing.assert_allclose(got.scores[b], one.scores[0], rtol=0, atol=TOL)


def test_hybrid_grouped_multibatch_matches_single(corpus, pair):
    """The group vector chunks with the queries: sub-batches of 5 and a
    rebatch of the prepared batch equal one batch."""
    masks, groups = _three_masks(), np.arange(NQ, dtype=np.int32) % 3
    term_ids, q = _queries(corpus, "xla")
    kw = {"k": K, "candidates_per_arm": C, "filter_mask": masks, "filter_group": groups}
    big = pair("xla", device_batch=NQ)[1]
    want = big.search_prepared(term_ids, q, **kw)
    got = pair("xla", device_batch=5)[1].search_prepared(term_ids, q, **kw)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=TOL)
    prep = big.prepare(term_ids, q, device_batch=6, **kw)
    re = big.rebatch(prep, 3)
    assert re.filter_group.shape == (4, 3) and re.filter_group_host.shape == (4, 3)
    got = big.finalize_prepared(re, big.run_prepared_device(re))
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=TOL)


def test_group_masks_reject_float_groups(corpus, pair):
    _, t = pair("xla")
    with pytest.raises(TypeError, match="integers"):
        t.search(["a", "b"], filter_mask=_three_masks(), filter_group=[0.9, 1.2])
