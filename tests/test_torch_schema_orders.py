"""The port's set-up orderings of ``PostingsIndex`` equal the reference's.

``ensure_impact_order`` builds the per-term (-impact, doc) permutation by
one stable sort of an int64 key, and ``pruned_cache`` puts each term's
top-M back into doc order by compacting a mask, where the reference
(``openintel_tpu.index.schema.PostingsIndex``) runs a lexsort for each.
Every case below goes through both and must give the same arrays, element
for element: indexes made to break a key (equal impacts, signed zeros,
negatives, infinities, subnormals, NaN, empty and one-posting segments,
no postings, term ids near the top of a large vocabulary, doc ids that do
not ascend within a term) and the synthetic bench index at several seeds.
"""

import zlib

import numpy as np
import pytest

from openintel_tpu.index import schema as jschema
from openintel_tpu.ops import tokenizer as jtok
from openintel_tpu_torch.index import schema as tschema
from openintel_tpu_torch.index.synthetic import synthetic_postings_index
from openintel_tpu_torch.ops import tokenizer as ttok
from openintel_tpu_torch.utils import profiling


@pytest.fixture
def fresh(monkeypatch):
    """A recorder of its own in place of the process's."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def route(rec, name):
    """The ``route`` attribute of the one span ``name`` (None without one)."""
    spans = [r for r in rec.records() if r.name == name]
    assert len(spans) <= 1
    return (spans[0].attrs or {}).get("route") if spans else None


def pair(term_offsets, doc_ids, impact, n_docs=None):
    """The port's and the reference's index over the same postings."""
    term_offsets = np.asarray(term_offsets, np.int64)
    doc_ids = np.asarray(doc_ids, np.int32)
    impact = np.asarray(impact, np.float32)
    v = term_offsets.shape[0] - 1
    n_docs = int(doc_ids.max()) + 1 if n_docs is None and doc_ids.size else (n_docs or 0)
    out = []
    for mod, tok in ((tschema, ttok), (jschema, jtok)):
        out.append(mod.PostingsIndex(
            term_offsets=term_offsets.copy(),
            doc_ids=doc_ids.copy(),
            tf=np.ones(doc_ids.shape[0], np.float32),
            impact=impact.copy(),
            df=np.diff(term_offsets).astype(np.int32),
            idf=np.ones(v, np.float32),
            doc_len=np.ones(n_docs, np.float32),
            avgdl=1.0,
            n_docs=n_docs,
            vocab=tok.Vocab(token_to_id={}),
            config=mod.BM25Config(),
        ))
    return out


def segments(lens, rng, n_docs=1_000):
    """CSR offsets over ``lens`` and doc ids ascending within each segment."""
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    docs = np.concatenate(
        [np.sort(rng.choice(n_docs, size=n, replace=False)) for n in lens]
    ).astype(np.int32) if sum(lens) else np.zeros(0, np.int32)
    return offs, docs


def case(name: str):
    """(term_offsets, doc_ids, impact) of one named index."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    lens = [0, 40, 1, 0, 300, 7, 1, 120, 0]
    offs, docs = segments(lens, rng)
    n = docs.shape[0]
    if name == "equal_impacts":
        imp = rng.choice(np.float32([0.5, 1.0, 2.0]), size=n)
    elif name == "signed_zeros":
        imp = rng.choice(np.float32([0.0, -0.0, 1.0, -1.0]), size=n)
    elif name == "negatives":
        imp = rng.standard_normal(n).astype(np.float32)
        imp[::5] = -np.abs(imp[::5])
    elif name == "extremes":
        vals = np.float32([np.inf, -np.inf, 1e-45, -1e-45, 1e-38, np.finfo(np.float32).max,
                           -np.finfo(np.float32).max, 0.0, -0.0, 3.0])
        imp = rng.choice(vals, size=n)
    elif name == "nan":
        imp = rng.choice(np.float32([np.nan, 0.0, -0.0, 1.0, 2.0]), size=n)
    elif name == "one_posting_segments":
        offs, docs = segments([1, 0, 1, 1, 0, 0, 1], rng)
        imp = np.float32([3.0, 3.0, -1.0, 0.0])
    elif name == "no_postings":
        offs, docs, imp = np.zeros(6, np.int64), np.zeros(0, np.int32), np.zeros(0, np.float32)
    elif name == "top_term_ids":
        # 2^20 terms; the postings sit in the last few, whose ids fill the key's high bits
        offs, docs = segments([50, 0, 9, 200], rng)
        offs = np.concatenate([np.zeros((1 << 20) - 4, np.int64), offs])
        imp = rng.choice(np.float32([0.25, 0.5, 1.0]), size=docs.shape[0])
    elif name == "docs_not_ascending":
        imp = rng.choice(np.float32([0.5, 1.0]), size=n)
        for lo, hi in zip(offs[:-1], offs[1:]):
            docs[lo:hi] = rng.permutation(docs[lo:hi])
    elif name == "repeated_docs":
        imp = rng.choice(np.float32([0.5, 1.0]), size=n)
        docs[1:n:3] = docs[0:n - 1:3]
        for lo, hi in zip(offs[:-1], offs[1:]):
            docs[lo:hi] = np.sort(docs[lo:hi])
    elif name in SYNTHETIC:
        n_docs, seed = SYNTHETIC[name]
        ix = synthetic_postings_index(n_docs, vocab_size=300, mean_len=12, seed=seed)
        return ix.term_offsets, ix.doc_ids, ix.impact
    else:
        raise KeyError(name)
    return offs, docs, np.asarray(imp, np.float32)


# the bench index's statistics; above 50,000 docs its ids are drawn with replacement
SYNTHETIC = {"synthetic_1": (3_000, 1), "synthetic_2": (3_000, 2), "synthetic_3": (60_000, 3)}
CASES = [
    "equal_impacts", "signed_zeros", "negatives", "extremes", "nan", "one_posting_segments",
    "no_postings", "top_term_ids", "docs_not_ascending", "repeated_docs",
    "synthetic_1", "synthetic_2", "synthetic_3",
]
# cases that keep the lexsort: a NaN impact, doc ids that do not strictly ascend in a term
LEXSORT = {"nan", "docs_not_ascending", "repeated_docs"}
UNSORTED = {"docs_not_ascending", "repeated_docs"}


@pytest.mark.parametrize("name", CASES)
def test_impact_order_equals_the_reference(name, fresh):
    got, want = pair(*case(name))
    order = got.ensure_impact_order()
    assert order.dtype == np.int64 and order.shape == (got.nnz,)
    np.testing.assert_array_equal(order, want.ensure_impact_order())
    assert got.ensure_impact_order() is order  # memoised
    expect = None if got.nnz == 0 else "lexsort" if name in LEXSORT else "key"
    assert route(fresh, "setup.impact_order") == expect


@pytest.mark.parametrize("m", [1, 128, 100_000])
@pytest.mark.parametrize("name", [
    "equal_impacts", "signed_zeros", "nan", "one_posting_segments", "no_postings",
    "top_term_ids", "docs_not_ascending", "repeated_docs", "synthetic_1", "synthetic_2",
])
def test_pruned_cache_equals_the_reference(name, m, fresh):
    got, want = pair(*case(name))
    g, w = got.pruned_cache(m), want.pruned_cache(m)
    for a, b, dtype in zip(g, w, (np.int64, np.int32, np.float32)):
        assert a.dtype == dtype and a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)
    assert got.pruned_cache(m) is g  # memoised
    expect = None if got.nnz == 0 else "lexsort" if name in UNSORTED else "mask"
    assert route(fresh, "setup.pruned_cache") == expect
