"""The port's own copies of the reference's host modules equal the originals.

The port imports nothing of the JAX package, so it keeps copies of the
jax-free host modules it needs: ``ops/tokenizer.py``, ``index/schema.py``,
``index/build.py``, ``index/synthetic.py``, ``native/`` (the C++
tokenizer, postings builder and query planner) and ``serving.py``'s
``fuse_filter_entries``. The same inputs go through
each copy and its original; every array must be equal, bit for bit. The
carry-across functions of ``convert`` must give port indexes whose arrays
are the JAX-built ones.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from openintel_tpu import native as jnative
from openintel_tpu import serving as jserving
from openintel_tpu.index import build as jbuild
from openintel_tpu.index import schema as jschema
from openintel_tpu.index import synthetic as jsyn
from openintel_tpu.ops import tokenizer as jtok
from openintel_tpu_torch import convert
from openintel_tpu_torch import native as tnative
from openintel_tpu_torch import serving as tserving
from openintel_tpu_torch.index import build as tbuild
from openintel_tpu_torch.index import schema as tschema
from openintel_tpu_torch.index import synthetic as tsyn
from openintel_tpu_torch.ops import tokenizer as ttok

TEXTS = [
    "AAPL to the MOON!! buying calls",
    "0dte-YOLO_calls $TSLA $$ @@@",
    "",
    "   ",
    "UPPER lower 123 mixed42case",
    "tabs\tand\nnewlines  spaced",
    "café über naïve — ünïcödé ß",
    "日本語 テキスト and ascii",
    "x" * 300,
]

POSTINGS_FIELDS = ("term_offsets", "doc_ids", "tf", "impact", "df", "idf", "doc_len")


@pytest.fixture(scope="module")
def libs():
    """Both native libraries built (the port's into its own build dir)."""
    for lib in (jnative, tnative):
        lib.build()
        if lib._load() is None:  # pragma: no cover - toolchain always present
            pytest.skip("native library unavailable")
    assert tnative.library_path().parent == tnative.BUILD_DIR
    return True


def _assert_postings_equal(got, want):
    for name in POSTINGS_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.avgdl, got.n_docs) == (want.avgdl, want.n_docs)
    assert got.vocab.token_to_id == want.vocab.token_to_id
    assert (got.config.k1, got.config.b) == (want.config.k1, want.config.b)


def test_tokenizer_copy_matches_original():
    """ASCII, unicode and empty strings; the batch tokenizer (native when
    built), the vocabulary and the padded encoding."""
    for text in TEXTS:
        assert ttok.tokenize(text) == jtok.tokenize(text), text
    assert ttok.tokenize_batch(TEXTS) == jtok.tokenize_batch(TEXTS)
    tv = ttok.Vocab.build(ttok.tokenize_batch(TEXTS))
    jv = jtok.Vocab.build(jtok.tokenize_batch(TEXTS))
    assert tv.token_to_id == jv.token_to_id and tv.size == jv.size
    for kw in ({}, {"pad_multiple": 8}, {"max_len": 3}):
        got = ttok.encode_padded(ttok.tokenize_batch(TEXTS), tv, **kw)
        want = jtok.encode_padded(jtok.tokenize_batch(TEXTS), jv, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_native_tokenizer_copy_matches_original(libs):
    """The port's C++ tokenizer is installed into the port's tokenizer (not
    the reference's) and agrees with the original library."""
    assert tnative.install()
    assert ttok._native_tokenize_batch is tnative.native_tokenize_batch
    assert tnative.native_tokenize_batch(TEXTS) == jnative.native_tokenize_batch(TEXTS)


@pytest.mark.parametrize("use_native", [True, False])
def test_build_postings_index_copy_matches_original(libs, use_native):
    texts = jsyn.synthetic_token_corpus(600, vocab_size=200, seed=91) + TEXTS
    got = tbuild.build_postings_index(texts, use_native=use_native)
    want = jbuild.build_postings_index(texts, use_native=use_native)
    _assert_postings_equal(got, want)
    cfg = tschema.BM25Config(k1=0.9, b=0.4)
    got = tbuild.build_postings_index(texts, config=cfg, avgdl_override=7.5)
    want = jbuild.build_postings_index(
        texts, config=jschema.BM25Config(k1=0.9, b=0.4), avgdl_override=7.5
    )
    _assert_postings_equal(got, want)


def test_synthetic_generators_copy_match_original():
    docs = tsyn.synthetic_token_corpus(300, vocab_size=150, seed=92)
    assert docs == jsyn.synthetic_token_corpus(300, vocab_size=150, seed=92)
    assert tsyn.synthetic_queries_from_docs(docs, 9, seed=93) == (
        jsyn.synthetic_queries_from_docs(docs, 9, seed=93)
    )
    emb = tsyn.synthetic_embeddings(500, dim=24, seed=94)
    np.testing.assert_array_equal(emb, jsyn.synthetic_embeddings(500, dim=24, seed=94))
    for got, want in zip(
        tsyn.synthetic_query_embeddings(emb, 7, seed=95),
        jsyn.synthetic_query_embeddings(emb, 7, seed=95),
    ):
        np.testing.assert_array_equal(got, want)
    got = tsyn.synthetic_postings_index(5_000, vocab_size=300, mean_len=10, seed=96)
    want = jsyn.synthetic_postings_index(5_000, vocab_size=300, mean_len=10, seed=96)
    assert isinstance(got, tschema.PostingsIndex)
    _assert_postings_equal(got, want)
    np.testing.assert_array_equal(got.ensure_impact_order(), want.ensure_impact_order())


def test_native_planner_copy_matches_original(libs):
    """The port's C++ planner gives the reference's plan for a query batch:
    pruned, multi-term budget, and through the pruned and bitmap caches."""
    idx = jsyn.synthetic_postings_index(20_000, vocab_size=400, mean_len=12, seed=97)
    port_idx = convert.postings_index(idx)
    rng = np.random.default_rng(98)
    term_ids = [list(rng.integers(1, 120, size=4)) for _ in range(300)]
    term_ids[0] = []
    for m, bitmap_min_df in ((16, None), (64, None), (64, 256)):
        kw = dict(bitmap_min_df=bitmap_min_df)
        got = tnative.native_build_query_plan(port_idx, term_ids, m, 16, **kw)
        want = jnative.native_build_query_plan(idx, term_ids, m, 16, **kw)
        assert got is not None and want is not None
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_schema_copy_matches_original():
    assert tschema.BM25Config() == tschema.BM25Config(
        k1=jschema.BM25Config().k1, b=jschema.BM25Config().b
    )
    assert tschema.dense_store_dtype("f32") == jschema.dense_store_dtype("f32")
    assert tschema.dense_store_dtype("bf16") == torch.bfloat16
    for name in ("f32", "bf16"):
        assert tschema.dense_store_name(tschema.dense_store_dtype(name)) == name
        assert tschema.dense_store_name(jschema.dense_store_dtype(name)) == name
    with pytest.raises(ValueError):
        tschema.dense_store_dtype("f16")
    raw = np.random.default_rng(99).standard_normal((50, 12)).astype(np.float32)
    raw[3] = 0.0  # a zero row stays zero
    got = tschema.DenseIndex.from_embeddings(raw)
    want = jschema.DenseIndex.from_embeddings(raw)
    np.testing.assert_array_equal(got.embeddings, want.embeddings)
    assert (got.n_docs, got.dim) == (want.n_docs, want.dim)


def test_convert_carries_jax_built_indexes_across():
    """``postings_index`` and ``dense_index_from`` give the port's classes
    holding the JAX-built arrays; the rows read back bit for bit (bf16
    through a 16-bit view)."""
    texts = jsyn.synthetic_token_corpus(400, vocab_size=120, seed=100)
    src = jbuild.build_postings_index(texts)
    src.ensure_impact_order()
    got = convert.postings_index(src)
    assert isinstance(got, tschema.PostingsIndex)
    _assert_postings_equal(got, src)
    np.testing.assert_array_equal(got.impact_order, src.impact_order)
    raw = jsyn.synthetic_embeddings(300, dim=16, seed=101)
    for dtype in (np.float32, ml_dtypes.bfloat16):
        dense = jschema.DenseIndex.from_embeddings(raw, dtype=dtype)
        port = convert.dense_index_from(dense)
        assert isinstance(port, tschema.DenseIndex)
        assert (port.n_docs, port.dim) == (dense.n_docs, dense.dim)
        rows = convert.stored_rows(port, "cpu")
        wide = dtype is np.float32
        np.testing.assert_array_equal(
            rows.view(torch.int32 if wide else torch.int16).numpy(),
            np.asarray(dense.embeddings).view(np.int32 if wide else np.int16),
        )


@pytest.mark.parametrize("case", ["mixed", "all-none", "duplicate-keys", "no-none"])
def test_fuse_filter_entries_copy_matches_original(case):
    """Random per-query filter entries: mixed filtered and unfiltered
    queries, none filtered, keys repeated (deduped by key, the first mask
    seen serves), and every query filtered."""
    rng = np.random.default_rng({"mixed": 1, "all-none": 2, "duplicate-keys": 3, "no-none": 4}[case])
    n_docs, n_q = 50, 24
    keys = [("tenant", i) for i in range(5)]
    masks = {k: rng.random(n_docs) < 0.5 for k in keys}
    entries = []
    for _ in range(n_q):
        k = keys[int(rng.integers(len(keys)))]
        if case == "all-none" or (case == "mixed" and rng.random() < 0.4):
            entries.append(None)
        elif case == "duplicate-keys":  # same key, another mask: the first one wins
            entries.append((k, rng.random(n_docs) < 0.5))
        else:
            entries.append((k, masks[k]))
    got = tserving.fuse_filter_entries(entries)
    want = jserving.fuse_filter_entries(entries)
    if case == "all-none":
        assert got == want == (None, None)
        return
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
