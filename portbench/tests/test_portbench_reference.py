"""The plain reference against brute-force NumPy loops over every doc."""

from __future__ import annotations

import ast

import numpy as np
import pytest
import torch

from conftest import REPO
from portbench.reference.bm25 import ExactBM25
from portbench.reference.dense import doc_scores, exact_top
from portbench.reference.fusion import ranked, zblend_scores
from portbench.reference.quant import quantize_int8


def _corpus(n_docs=300, vocab=40, seed=0):
    r = np.random.default_rng(seed)
    doc_terms = [r.choice(vocab, size=r.integers(1, 12)) + 1 for _ in range(n_docs)]
    tf = {}
    for d, terms in enumerate(doc_terms):
        for t in terms:
            tf[(int(t), d)] = tf.get((int(t), d), 0) + 1
    offsets = np.zeros(vocab + 2, np.int64)
    ids, tfs = [], []
    for t in range(1, vocab + 1):
        docs = sorted(d for (tt, d) in tf if tt == t)
        ids += docs
        tfs += [tf[(t, d)] for d in docs]
        offsets[t + 1] = len(ids)
    doc_len = np.array([len(x) for x in doc_terms], np.float32)
    return offsets, np.array(ids, np.int32), np.array(tfs, np.float32), doc_len, tf


def _bm25_loop(q, tf, doc_len, n_docs, df, k1=1.2, b=0.75):
    avgdl = float(doc_len.astype(np.float64).mean())
    out = np.zeros(n_docs)
    terms = {}
    for t in q:
        terms[t] = terms.get(t, 0) + 1
    for t, qtf in terms.items():
        idf = np.log1p((n_docs - df[t] + 0.5) / (df[t] + 0.5))
        for d in range(n_docs):
            f = tf.get((t, d), 0)
            if f:
                out[d] += idf * qtf * f * (k1 + 1) / (f + k1 * (1 - b + b * doc_len[d] / avgdl))
    return out


def _top(scores, c, valid):
    order = sorted((-s, d) for d, s in enumerate(scores) if valid[d])[:c]
    return [d for _, d in order], [-s for s, _ in order]


@pytest.mark.parametrize("masked", [False, True])
def test_bm25_matches_a_loop_over_every_doc(masked):
    offsets, ids, tfs, doc_len, tf = _corpus()
    n = doc_len.shape[0]
    df = np.diff(offsets)
    ref = ExactBM25(offsets, torch.from_numpy(ids), torch.from_numpy(tfs), torch.from_numpy(doc_len))
    r = np.random.default_rng(1)
    queries = [list(r.integers(1, 41, size=r.integers(1, 6))) for _ in range(20)]
    mask = r.random((20, n)) < 0.3 if masked else np.ones((20, n), bool)
    vals, got = ref.top(queries, 10, torch.from_numpy(mask) if masked else None, block=7)
    for i, q in enumerate(queries):
        scores = _bm25_loop(q, tf, doc_len, n, df)
        want_ids, want_vals = _top(scores, 10, mask[i] & (scores > 0))
        assert got[i, : len(want_ids)].tolist() == want_ids
        assert (got[i, len(want_ids):] == -1).all()
        np.testing.assert_allclose(vals[i, : len(want_ids)].numpy(), want_vals, rtol=1e-6)


@pytest.mark.parametrize("low", [False, True])
def test_dense_matches_a_loop_over_every_doc(low):
    r = np.random.default_rng(2)
    rows = r.standard_normal((500, 48)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    q = r.standard_normal((9, 48)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask = r.random((9, 500)) < 0.5
    vals, ids = exact_top(torch.from_numpy(rows), torch.from_numpy(q), 7, torch.from_numpy(mask),
                          block=64, low_precision=low)
    rq = np.clip(np.rint(127 * rows), -127, 127) if low else rows
    qq = np.clip(np.rint(127 * q), -127, 127) if low else q
    for i in range(9):
        sc = [float(np.dot(qq[i].astype(np.float64), rq[d].astype(np.float64))) / (127.0**2 if low else 1)
              for d in range(500)]
        want_ids, want_vals = _top(sc, 7, mask[i])
        assert ids[i].tolist() == want_ids
        np.testing.assert_allclose(vals[i].numpy(), want_vals, rtol=1e-5, atol=1e-6)
    got = doc_scores(torch.from_numpy(rows), torch.from_numpy(q), ids)
    np.testing.assert_allclose(got.numpy(), (q[:, None, :] * rows[ids.numpy()]).sum(-1), atol=1e-6)


def test_quantiser_rounds_half_to_even_and_clips():
    x = torch.tensor([0.5 / 127, 1.5 / 127, -2.5 / 127, 1.2, -1.2, 0.0])
    assert quantize_int8(x).tolist() == [0, 2, -2, 127, -127, 0]


def test_zblend_matches_its_definition():
    b_vals, b_ids = np.array([9.0, 7.0, 4.0, 0.0]), np.array([5, 3, 8, -1])
    d_vals, d_ids = np.array([0.9, 0.8, 0.2]), np.array([3, 11, 5])
    fused = zblend_scores(b_vals, b_ids, d_vals, d_ids, 0.7)

    def z(v):
        return (v - v.mean()) / np.sqrt(v.var() + 1e-6)

    zb = dict(zip([5, 3, 8], z(np.array([9.0, 7.0, 4.0]))))
    zd = dict(zip([3, 11, 5], z(d_vals)))
    for d in (5, 3, 8, 11):
        want = 0.7 * zb.get(d, min(zb.values())) + 0.3 * zd.get(d, min(zd.values()))
        assert fused[d] == pytest.approx(want)
    vals, ids = ranked(fused, 6)
    assert ids[:4].tolist() == sorted(fused, key=lambda d: (-fused[d], d)) and ids[4:].tolist() == [-1, -1]


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"openintel_tpu_torch", "openintel_tpu", "jax", "jaxlib", "flax"}, path


def test_harness_imports_no_jax():
    for path in (REPO / "portbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not {n.split(".")[0] for n in names} & {"openintel_tpu", "jax", "jaxlib", "flax"}, path
