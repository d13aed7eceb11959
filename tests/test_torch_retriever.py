"""Port parity for the slice as a whole: openintel_tpu_torch.models
against openintel_tpu.models (retrievers, the hashing embedder).

The same index and the same seeded queries go through the JAX retrievers
(Pallas kernels in interpret mode on the CPU) and the port's (plain twins on
CPU tensors). Tolerance, the near-tie rule: fused scores agree to 1e-5 (the
z-blend and the f32 rescore sum in another order than XLA); ids are equal
except inside clusters of scores within 1e-5, where the id sets agree.

``kernel="fast"`` has no rescore: its dense scores are kernel D's f32 sums
truncated to steps of 2**-16, and a sum in another order can move one by a
step, which moves a fused score by ~1e-3. Its cases therefore run on dyadic
rows and queries (exact in any sum order, ``torch_dense_utils``), given to
both packages as they are (a ``DenseIndex`` made directly, or an embedder
whose rows are exactly unit-norm), so the 1e-5 rule holds.
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
    synthetic_queries_from_docs,
    synthetic_query_embeddings,
    synthetic_token_corpus,
)
from openintel_tpu.models import retrievers as jr
from openintel_tpu.models.embedding import HashingEmbedder as JaxEmbedder
from openintel_tpu_torch import convert
from openintel_tpu_torch.index import schema as tschema
from openintel_tpu_torch.models import retrievers as tr
from openintel_tpu_torch.models.embedding import HashingEmbedder

TOL = 1e-5
N = 20_000  # two int8 supers, the last one short
DIM = 64
K, C = 10, 32


def _assert_close(got, want):
    assert got.ids.shape == want.ids.shape and got.ids.dtype == np.int32
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=TOL)
    assert_ranking_close(got.scores, got.ids, want.scores, want.ids, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def corpus():
    index = synthetic_postings_index(N, vocab_size=2_000, seed=3)
    emb = synthetic_embeddings(N, dim=DIM, seed=4)
    rng = np.random.default_rng(5)
    ranks = np.exp(rng.uniform(np.log(20), np.log(1_999), size=(40, 3)))
    term_ids = [list(r + 1) for r in ranks.astype(np.int64)]
    term_ids[7] = []  # a query with no known terms
    q, _ = synthetic_query_embeddings(emb, 40, seed=6)
    return index, emb, term_ids, q


@pytest.fixture(scope="module")
def dyadic():
    """Dyadic doc rows and 40 dyadic queries for the fast cases."""
    rng = np.random.default_rng(8)
    return dyadic_rows(rng, N, DIM), dyadic_rows(rng, 40, DIM)


def _sign_embedder(texts):
    """Rows of +-1/8 over 64 dims: exactly unit-norm (normalising leaves
    them as they are) and dyadic."""
    return np.where(HashingEmbedder(dim=DIM)(texts) >= 0, 0.125, -0.125).astype(
        np.float32
    )


def _pair(corpus, kernel, store, fusion, device_batch=16, rows=None):
    index, emb, _, _ = corpus
    dtype = ml_dtypes.bfloat16 if store == "bf16" else np.float32
    if rows is None:
        dense = DenseIndex.from_embeddings(emb, dtype=dtype)
    else:  # as they are: normalising would make them non-dyadic
        dense = DenseIndex(embeddings=rows.astype(dtype), n_docs=N, dim=DIM)
    j = jr.HybridRetriever(
        index, dense, kernel=kernel, fusion=fusion, device_batch=device_batch
    )
    t = tr.HybridRetriever(  # the JAX-built index carried across
        convert.postings_index(index), convert.dense_index_from(dense),
        kernel=kernel, fusion=fusion, device_batch=device_batch, device="cpu",
    )
    return j, t


@pytest.mark.parametrize("fusion", ["zblend", "rrf"])
@pytest.mark.parametrize(
    "kernel,store",
    [
        ("xla", "bf16"), ("int8", "bf16"), ("pallas", "f32"),
        ("fast", "bf16"), ("fast", "f32"), ("int4", "bf16"),
    ],
)
def test_hybrid_matches_jax(corpus, dyadic, kernel, store, fusion):
    """40 queries in sub-batches of 16 (the last one padded)."""
    _, _, term_ids, q = corpus
    rows = None
    if kernel == "fast":
        rows, q = dyadic
    j, t = _pair(corpus, kernel, store, fusion, rows=rows)
    assert t.kernel == kernel
    want = j.search_prepared(term_ids, q, k=K, candidates_per_arm=C)
    got = t.search_prepared(term_ids, q, k=K, candidates_per_arm=C)
    assert got.ids.shape == (40, K)
    _assert_close(got, want)


def test_prepare_rebatch_and_device_result(corpus):
    _, _, term_ids, q = corpus
    j, t = _pair(corpus, "int8", "bf16", "zblend")
    prep = t.prepare(term_ids[:32], q[:32], k=K, candidates_per_arm=C)
    assert prep.queries.shape == (2, 16, DIM) and prep.queries.dtype == torch.float32
    assert prep.queries_i8.dtype == torch.int8
    whole = t.run_prepared(prep)
    vals, ids = t.run_prepared_device(t.rebatch(prep, 8))
    assert vals.shape == (4, 8, K) and ids.dtype == torch.int32
    rebatched = t.finalize_prepared(prep, (vals, ids))
    np.testing.assert_array_equal(rebatched.ids, whole.ids)
    np.testing.assert_array_equal(rebatched.scores, whole.scores)
    jprep = j.prepare(term_ids[:32], q[:32], k=K, candidates_per_arm=C)
    _assert_close(rebatched, j.run_prepared(j.rebatch(jprep, 8)))
    with pytest.raises(ValueError):
        t.rebatch(prep, 5)


def test_empty_batch(corpus):
    _, t = _pair(corpus, "xla", "f32", "zblend")
    res = t.search([], k=K)
    assert res.ids.shape == (0, K) and res.scores.shape == (0, K)
    prep = t.prepare([], np.zeros((0, DIM), np.float32), k=K)
    assert prep.n_queries == 0
    assert t.run_prepared(prep).ids.shape == (0, K)


@pytest.mark.parametrize("kernel", ["xla", "int8", "pallas", "fast", "int4"])
def test_text_search_k_beyond_n_docs(kernel):
    """Built from text: k = 50 over 30 docs pads every ranking with
    (0.0, -1) exactly as the JAX retriever does."""
    docs = synthetic_token_corpus(30, vocab_size=60, seed=7)
    queries = synthetic_queries_from_docs(docs, 5, seed=8) + ["unknown words"]
    embedder = _sign_embedder if kernel == "fast" else None
    j = jr.HybridRetriever.build(docs, dim=DIM, kernel=kernel, embedder=embedder)
    t = tr.HybridRetriever.build(
        docs, dim=DIM, kernel=kernel, embedder=embedder, device="cpu"
    )
    want, got = j.search(queries, k=50), t.search(queries, k=50)
    assert got.ids.shape == (6, 30)  # k clamps to n_docs, as in the reference
    _assert_close(got, want)
    assert (got.ids[:5, 0] >= 0).all()  # the queries drawn from the docs


def test_text_search_default_kernel_matches_jax():
    docs = synthetic_token_corpus(400, vocab_size=300, seed=9)
    queries = synthetic_queries_from_docs(docs, 9, seed=10)
    j = jr.HybridRetriever.build(docs, dim=DIM)
    t = tr.HybridRetriever.build(docs, dim=DIM, device="cpu")
    assert t.kernel == j.kernel == "xla"  # the CPU default of both packages
    _assert_close(t.search(queries, k=K), j.search(queries, k=K))


def test_bm25_and_dense_retrievers_match_jax(corpus, dyadic):
    index, emb, _, q = corpus
    texts = ["t21 t40 t77", "t30", "t1999 t25 t25", "nothing known"]
    jb = jr.BM25Retriever(index).search(texts, k=K)
    tb = tr.BM25Retriever(convert.postings_index(index), device="cpu").search(texts, k=K)
    np.testing.assert_array_equal(tb.ids, jb.ids)
    np.testing.assert_array_equal(tb.scores, jb.scores)
    dense = DenseIndex.from_embeddings(emb, dtype=ml_dtypes.bfloat16)
    rows, dq = dyadic
    dyadic_dense = DenseIndex(
        embeddings=rows.astype(ml_dtypes.bfloat16), n_docs=N, dim=DIM
    )
    for kernel in ("xla", "int8", "pallas", "int4", "fast"):
        d, qq = (dyadic_dense, dq) if kernel == "fast" else (dense, q)
        jd = jr.DenseRetriever(d, kernel=kernel).search_embeddings(qq[:9], K)
        td = tr.DenseRetriever(convert.dense_index_from(d), kernel=kernel, device="cpu")
        _assert_close(td.search_embeddings(qq[:9], K), jd)


def test_hashing_embedder_copy_matches_original():
    texts = ["Apple beats earnings", "", "t1 t2 t1", "NVDA to the moon!"]
    for dim in (16, 384):
        np.testing.assert_array_equal(
            HashingEmbedder(dim=dim, seed=3)(texts), JaxEmbedder(dim=dim, seed=3)(texts)
        )


def test_auto_select_mirrors_the_reference():
    """cpu -> the exact product; on an accelerator, int8 at >= 100k docs and
    kernel B below (checked on the meta device, which holds no data)."""
    small = tschema.DenseIndex.from_embeddings(synthetic_embeddings(500, dim=16, seed=11))
    big = tschema.DenseIndex.from_embeddings(np.ones((tr.AUTO_PRUNE_DOCS, 8), np.float32))
    assert tr.DenseRetriever(small, device="cpu").kernel == "xla"
    assert tr.DenseRetriever(small, device="meta").kernel == "pallas"
    meta_big = tr.DenseRetriever(big, device="meta")
    assert meta_big.kernel == "int8"
    # padded once, at load: rows to whole supers, features to 16 columns
    assert meta_big._emb_device.shape == (7 * 16_384, 16)
    assert meta_big._emb_device.dtype == torch.int8
    assert tr.DenseRetriever(small, use_pallas=True, device="cpu").kernel == "pallas"
    assert tr.DenseRetriever(small, use_pallas=False, device="meta").kernel == "xla"


def test_unported_paths_raise(corpus):
    """What the reference refuses, the port refuses: unknown kernels and
    fusions, and malformed filters on each retriever (same error type and
    message); a well-formed filter serves, equal to the JAX retriever."""
    index, emb, term_ids, q = corpus
    dense = DenseIndex.from_embeddings(emb[:100])
    with pytest.raises(ValueError):
        tr.DenseRetriever(dense, kernel="nope", device="cpu")
    with pytest.raises(ValueError):
        tr.dense_arm_topk("nope", torch.zeros(1, 1), torch.zeros(1, 1), 1, n_docs=1)
    docs = ["a b", "b c", "c d"]
    t = tr.HybridRetriever.build(docs, dim=8, device="cpu")
    j = jr.HybridRetriever.build(docs, dim=8)
    bad = [
        ({"filter_mask": np.ones(3, np.int32)}, TypeError, "bool"),
        ({"filter_mask": np.ones(4, bool)}, ValueError, "shape"),
        ({"filter_group": [0]}, ValueError, "requires filter_mask"),
    ]
    for retr in (t, t.dense, t.bm25):
        for kwargs, err, match in bad:
            with pytest.raises(err, match=match):
                retr.search(["a"], **kwargs)
    mask = np.array([True, False, True])
    for got, want in (
        (t.search(["b c"], k=3, filter_mask=mask), j.search(["b c"], k=3, filter_mask=mask)),
        (t.dense.search(["b c"], 3, filter_mask=mask), j.dense.search(["b c"], 3, filter_mask=mask)),
        (t.bm25.search(["b c"], 3, filter_mask=mask), j.bm25.search(["b c"], 3, filter_mask=mask)),
    ):
        _assert_close(got, want)
        assert not (got.ids == 1).any()
    with pytest.raises(ValueError):
        tr.HybridRetriever.build(["a"], dim=8, fusion="max", device="cpu")
