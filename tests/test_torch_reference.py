"""The port's NumPy oracle (``openintel_tpu_torch/ops/reference.py``) equals
the reference's (``openintel_tpu/ops/reference.py``) function by function,
by output: the same inputs, made from a seed with numpy, give arrays equal
in value, dtype and shape (ties to the lower id, ``k`` past the corpus,
empty queries, repeated query terms, short rankings' padding, both
fusions, the hybrid and its filtered form). Both oracles run the same
NumPy arithmetic, so nothing is compared under a tolerance. The BM25
functions get each package's own ``PostingsIndex`` built from the same
texts (the two builders are held equal in ``test_torch_host_copies.py``).
"""

import numpy as np
import pytest

from openintel_tpu.index.build import build_postings_index as ref_build
from openintel_tpu.ops import reference as ref
from openintel_tpu_torch.index.build import build_postings_index as port_build
from openintel_tpu_torch.ops import reference as port

WORDS = [f"w{i}" for i in range(40)]


def _texts(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(3, 12)))) for _ in range(n)]


@pytest.fixture(scope="module")
def indexes():
    texts = _texts(0, 120)
    return ref_build(texts), port_build(texts)


def _same(a, b) -> None:
    """Two outputs equal: arrays in value, dtype and shape, tuples item by item."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def test_constants_are_the_references():
    assert port.RRF_K == ref.RRF_K == 60.0
    assert port.BLEND_ALPHA == ref.BLEND_ALPHA == 0.7


@pytest.mark.parametrize("k", [1, 5, 40, 41, 100])  # 40 = N; 41, 100 past it
@pytest.mark.parametrize("kind", ["random", "ties", "constant", "single", "f64", "inf"])
def test_rank_topk(kind, k):
    rng = np.random.default_rng(3)
    scores = {
        "random": rng.standard_normal((6, 40)).astype(np.float32),
        "ties": np.round(rng.uniform(0, 3, (6, 40))).astype(np.float32),  # 4 values
        "constant": np.ones((3, 40), np.float32),
        "single": rng.standard_normal(40).astype(np.float32),  # (N,) in, (k,) out
        "f64": rng.standard_normal((4, 40)),
        "inf": np.where(rng.uniform(size=(5, 40)) < 0.5, -np.inf, 1.0).astype(np.float32),
    }[kind]
    _same(port.rank_topk(scores, k), ref.rank_topk(scores, k))
    vals, ids = port.rank_topk(scores, k)
    if kind in ("ties", "constant"):  # within equal scores the lower id first
        v, i = np.atleast_2d(vals), np.atleast_2d(ids)
        same = v[:, 1:] == v[:, :-1]
        assert (i[:, 1:][same] > i[:, :-1][same]).all()


QUERIES = [
    [],  # empty: no doc ranks
    [0, 0],  # padding ids only
    [3],
    [3, 3, 3],  # repeats weigh as query tf
    [5, 9, 5, 1],
    [2, 7, 11, 13, 17, 19],
    [10_000],  # an id no doc holds
]


@pytest.mark.parametrize("terms", QUERIES, ids=[str(q) for q in QUERIES])
def test_bm25_scores(indexes, terms):
    r_idx, p_idx = indexes
    terms = [t for t in terms if t < r_idx.idf.shape[0]]
    _same(port.bm25_scores(p_idx, terms), ref.bm25_scores(r_idx, terms))


@pytest.mark.parametrize("k", [1, 10, 120, 500])  # 120 = N; 500 pads with (0, -1)
@pytest.mark.parametrize("terms", QUERIES[:6], ids=[str(q) for q in QUERIES[:6]])
@pytest.mark.parametrize("masked", [False, True])
def test_bm25_topk(indexes, terms, k, masked):
    r_idx, p_idx = indexes
    mask = (np.arange(r_idx.n_docs) % 3 != 0) if masked else None
    _same(
        port.bm25_topk(p_idx, terms, k, doc_mask=mask),
        ref.bm25_topk(r_idx, terms, k, doc_mask=mask),
    )


def _emb(seed: int, n: int, dim: int = 16, dup: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, dim)).astype(np.float32)
    if dup:  # exact duplicate rows: equal cosines
        e[1::2] = e[::2][: e[1::2].shape[0]]
    return e * rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)  # not unit norm


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("single", [False, True])
def test_cosine_scores(dup, single):
    e = _emb(5, 60, dup=dup)
    q = _emb(6, 4)[0] if single else _emb(6, 4)
    _same(port.cosine_scores(e, q), ref.cosine_scores(e, q))


@pytest.mark.parametrize("k", [1, 10, 60, 75])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("mask", [None, "half", "three"])
@pytest.mark.parametrize("single", [False, True])
def test_cosine_topk(k, dup, mask, single):
    e = _emb(7, 60, dup=dup)
    q = _emb(8, 5)[0] if single else _emb(8, 5)
    doc_mask = {None: None, "half": np.arange(60) % 2 == 0, "three": np.isin(np.arange(60), [4, 9, 30])}[mask]
    _same(port.cosine_topk(e, q, k, doc_mask=doc_mask), ref.cosine_topk(e, q, k, doc_mask=doc_mask))


def _lists(seed: int, b: int, width: int, n_ids: int, pad: int):
    """Ranked id lists with ``pad`` trailing -1s a row and heavy overlap."""
    rng = np.random.default_rng(seed)
    out = np.full((b, width), -1, np.int32)
    for i in range(b):
        out[i, : width - pad] = rng.choice(n_ids, size=width - pad, replace=False)
    return out


@pytest.mark.parametrize("rrf_k", [1.0, 60.0, 120.0])
@pytest.mark.parametrize("k", [3, 10, 40])  # 40: more than the unique candidates, padded
@pytest.mark.parametrize("shape", ["batched", "single", "three lists", "padded"])
def test_rrf_fuse(shape, k, rrf_k):
    a, b, c = _lists(1, 4, 12, 20, 0), _lists(2, 4, 12, 20, 0), _lists(3, 4, 8, 20, 0)
    lists = {
        "batched": [a, b],
        "single": [a[0], b[0]],
        "three lists": [a, b, c],
        "padded": [_lists(4, 4, 12, 20, 5), _lists(5, 4, 12, 20, 12)],  # one arm empty
    }[shape]
    _same(port.rrf_fuse(lists, k, rrf_k=rrf_k), ref.rrf_fuse(lists, k, rrf_k=rrf_k))


def _arm(seed: int, b: int, width: int, pad: int, ties: bool):
    rng = np.random.default_rng(seed)
    ids = _lists(seed, b, width, 25, pad)
    vals = np.sort(rng.uniform(0, 10, (b, width)).astype(np.float32), axis=1)[:, ::-1]
    if ties:
        vals = np.round(vals)
    return np.where(ids >= 0, vals, 0.0).astype(np.float32), ids


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.7, 1.0])
@pytest.mark.parametrize("k", [5, 30])  # 30: padded
@pytest.mark.parametrize("case", ["plain", "ties", "one arm empty", "both short", "single"])
def test_zblend_fuse(case, k, alpha):
    pad_a, pad_b = {"one arm empty": (0, 10), "both short": (6, 8)}.get(case, (0, 0))
    va, ia = _arm(11, 3, 10, pad_a, case == "ties")
    vb, ib = _arm(12, 3, 10, pad_b, case == "ties")
    if case == "single":
        va, ia, vb, ib = va[0], ia[0], vb[0], ib[0]
    _same(
        port.zblend_fuse(va, ia, vb, ib, k, alpha=alpha),
        ref.zblend_fuse(va, ia, vb, ib, k, alpha=alpha),
    )


@pytest.mark.parametrize("fusion", ["zblend", "rrf"])
@pytest.mark.parametrize("c", [None, 4, 30])
@pytest.mark.parametrize("terms", QUERIES[:6], ids=[str(q) for q in QUERIES[:6]])
@pytest.mark.parametrize("masked", [False, True])
def test_hybrid_topk(indexes, terms, fusion, c, masked):
    r_idx, p_idx = indexes
    e = _emb(21, r_idx.n_docs, dup=True)
    q = _emb(22, 1)[0]
    mask = (np.arange(r_idx.n_docs) % 4 == 1) if masked else None
    kw = dict(candidates_per_arm=c, fusion=fusion, blend_alpha=0.6, rrf_k=30.0, doc_mask=mask)
    _same(
        port.hybrid_topk(p_idx, e, terms, q, 10, **kw),
        ref.hybrid_topk(r_idx, e, terms, q, 10, **kw),
    )


def test_the_oracle_imports_only_numpy_and_the_ports_schema():
    import ast
    from pathlib import Path

    tree = ast.parse(Path(port.__file__).read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    assert mods == {"__future__", "typing", "numpy", "openintel_tpu_torch.index.schema"}
