"""Kernel B v2 (``csrc/fused_topk_v2.cu``) as the Hopper kernel runs it, and
the feature padding of the card kernels' operands.

A numpy model of v2's selection: per corpus split (``fused_plan``), doc
tiles scored as float32 products; per query row a threshold (the k-th
(score, id) of the row's list), candidates that rank before it appended to
a buffer of ``cap`` entries in chunks of 32 (a warp's ballot), the buffer
and the list sorted by (score desc, id asc) when a chunk would overflow it
and at the end of the split; then the splits' lists merged 32 at a time by
their heads, in passes. The model is held to the plain twin
(``fused_topk_plain``) and to the JAX ``dense_topk_pallas`` in interpret
mode.

Tolerance: near-tie rule (scores within 2e-6; ids equal except where two
docs' scores differ by less than 1e-5; the model's tile products and the
twin's blocked product sum in another order); exact ids on duplicate rows
(lower id first). The padding tests are exact: dyadic operands make every
float32 sum exact in any order, and int8 dots are exact anyway.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from ranking_utils import assert_ranking_close
from torch_dense_utils import dyadic_rows

from openintel_tpu.index.synthetic import synthetic_embeddings, synthetic_query_embeddings
from openintel_tpu.ops.pallas import dense_topk as J
from openintel_tpu_torch import convert
from openintel_tpu_torch.index.schema import DenseIndex
from openintel_tpu_torch.index.synthetic import synthetic_postings_index
from openintel_tpu_torch.models.retrievers import HybridRetriever
from openintel_tpu_torch.ops import dense_topk as T

ATOL = 2e-6
TIE = 1e-5
CHUNK = 32  # scores a warp tests per ballot


def _rank(vals, ids):
    """Order of (score desc, id asc); empty slots (-inf, -1) last."""
    return np.lexsort((np.where(ids < 0, np.iinfo(np.int64).max, ids), -vals))


class SplitModel:
    """One (split, query row) of the partial kernel."""

    def __init__(self, k, cap):
        self.k, self.cap = k, cap
        self.list_v = np.zeros(0, np.float32)
        self.list_i = np.zeros(0, np.int64)
        self.buf_v, self.buf_i = [], []
        self.thr = (-np.inf, -1)
        self.compactions = 0

    def passes(self, v, i, g=-np.inf):
        tv, ti = self.thr
        return (v >= g) & ((v > tv) | ((v == tv) & (i < ti)))

    def compact(self):
        v = np.concatenate([self.list_v, np.asarray(self.buf_v, np.float32)])
        i = np.concatenate([self.list_i, np.asarray(self.buf_i, np.int64)])
        order = _rank(v, i)[: self.k]
        self.list_v, self.list_i = v[order], i[order]
        self.buf_v, self.buf_i = [], []
        if self.list_v.size == self.k:
            self.thr = (self.list_v[-1], self.list_i[-1])
        self.compactions += 1

    def chunk(self, v, i, g=-np.inf):
        """One ballot, under the shared threshold ``g``: returns True if the
        buffer overflowed."""
        m = self.passes(v, i, g)
        overflow = False
        if m.any() and len(self.buf_v) + int(m.sum()) > self.cap:
            self.compact()
            overflow = True
            m = self.passes(v, i, g)
        self.buf_v += v[m].tolist()
        self.buf_i += i[m].tolist()
        return overflow

    def finish(self):
        if self.buf_v:
            self.compact()
        out_v = np.full(self.k, -np.inf, np.float32)
        out_i = np.full(self.k, -1, np.int64)
        out_v[: self.list_v.size], out_i[: self.list_i.size] = self.list_v, self.list_i
        return out_v, out_i


def merge_heads(lists_v, lists_i, k):
    """The merge kernel for one group of <= 32 sorted lists of one row: the
    best head, k times; exhausted lists and empty slots never win."""
    heads = [0] * len(lists_v)
    out_v = np.full(k, -np.inf, np.float32)
    out_i = np.full(k, -1, np.int64)
    for t in range(k):
        best = None
        for p, (lv, li) in enumerate(zip(lists_v, lists_i)):
            h = heads[p]
            if h >= k or li[h] < 0:
                continue
            if best is None or (lv[h], -li[h]) > (lists_v[best][heads[best]], -lists_i[best][heads[best]]):
                best = p
        if best is None:
            break
        out_v[t], out_i[t] = lists_v[best][heads[best]], lists_i[best][heads[best]]
        heads[best] += 1
    return out_v, out_i


def v2_model(docs, queries, k, plan, stats=None, share=True):
    """Kernel B v2 on (N, D) docs and (B, D) queries (numpy, any float
    dtype) under ``plan`` (``T.fused_plan``): (vals (B, k), ids (B, k)),
    empty slots (-inf, -1). ``share``: each query's splits publish their
    k-th score once their list is full, and every split drops scores below
    the best published one (read per tile). The kernel's splits run at
    once and read whatever has been published; here they run one after
    the other, so later splits see the most."""
    shared = np.full(queries.shape[0], -np.inf, np.float32)
    n, b = docs.shape[0], queries.shape[0]
    nt, split_len, cap = plan["nt"], plan["split_len"], plan["cap"]
    q = torch.from_numpy(np.asarray(queries, np.float32))
    lists_v = np.zeros((plan["n_split"], b, k), np.float32)
    lists_i = np.zeros((plan["n_split"], b, k), np.int64)
    for s in range(plan["n_split"]):
        lo, hi = s * split_len, min((s + 1) * split_len, n)
        rows = [SplitModel(k, cap) for _ in range(b)]
        for t, t0 in enumerate(range(lo, hi, nt)):
            tile = torch.from_numpy(np.asarray(docs[t0 : min(t0 + nt, hi)], np.float32))
            scores = (q @ tile.T).numpy()
            for r, row in enumerate(rows):
                g = shared[r]  # read once per tile
                for j in range(0, scores.shape[1], CHUNK):
                    v = scores[r, j : j + CHUNK]
                    ids = np.arange(t0 + j, t0 + j + v.size)
                    if row.chunk(v, ids, g) and stats is not None:
                        stats.setdefault("first_overflow_tile", t)
                    if share and row.list_v.size == k:
                        shared[r] = max(shared[r], row.list_v[-1])
        for r, row in enumerate(rows):
            lists_v[s, r], lists_i[s, r] = row.finish()
            if stats is not None:
                stats["compactions"] = stats.get("compactions", 0) + row.compactions
    return merge_passes(lists_v, lists_i, k, stats)


def merge_passes(lists_v, lists_i, k, stats=None):
    """(n_lists, B, k) sorted lists -> (B, k): passes of 32 lists, as the
    wrapper launches them."""
    b = lists_v.shape[1]
    while True:
        n_lists = lists_v.shape[0]
        groups = -(-n_lists // 32)
        out_v = np.zeros((groups, b, k), np.float32)
        out_i = np.zeros((groups, b, k), np.int64)
        for g in range(groups):
            for r in range(b):
                out_v[g, r], out_i[g, r] = merge_heads(
                    lists_v[32 * g : 32 * g + 32, r], lists_i[32 * g : 32 * g + 32, r], k
                )
        if stats is not None:
            stats["passes"] = stats.get("passes", 0) + 1
        lists_v, lists_i = out_v, out_i
        if n_lists <= 32:
            return lists_v[0], lists_i[0]


STREAM_ROWS = 64  # the stream route's shared slots a row: list + buffer
STREAM_TILE = 64  # docs a wgmma tile (half a 128-doc sub-block)


def stream_units(plan, cta):
    """The doc ranges block ``cta`` of a query tile walks on the stream, in
    order: per unit (super, lane half, part), the 64-doc tiles of its part's
    sub-blocks, ascending."""
    parts, ctas = plan["parts"], plan["ctas_per_qt"]
    per_part = T._SUPER // parts
    for u in range(cta, plan["n_super"] * 2 * parts, ctas):
        part, half, s = u % parts, (u // parts) % 2, u // (2 * parts)
        for pos in range(part * per_part, (part + 1) * per_part):
            yield s * T._TURBO_UNIT + pos * 128 + half * STREAM_TILE


QUADS = 8  # rows of a warp that compact together (one a quad of lanes)


def stream_model(docs, queries, k, sms=132, stats=None):
    """Kernel B's stream route (``fused_topk_v2_tma``) on (N, D) docs and
    (B, D) queries: per block of ``T.fused_stream_plan``, one list per query
    row gathered over every unit it walks; per 64-doc tile and row, two
    ballots of 32 columns, a buffer of 64 - k slots; when any of 8
    neighbouring rows (a warp's quads, rows 8 g .. 8 g + 7) would overflow,
    all 8 compact, and all compact at the end; the k-th score shared across
    blocks once a list is full; then the blocks' lists merged in passes of
    32."""
    n, b = docs.shape[0], queries.shape[0]
    plan = T.fused_stream_plan(b, n, sms)
    scores = (torch.from_numpy(np.asarray(queries, np.float32))
              @ torch.from_numpy(np.asarray(docs, np.float32)).T).numpy()
    shared = np.full(b, -np.inf, np.float32)
    ctas = plan["ctas_per_qt"]
    lists_v = np.zeros((ctas, b, k), np.float32)
    lists_i = np.zeros((ctas, b, k), np.int64)
    for cta in range(ctas):  # the blocks of every query tile walk alike
        rows = [SplitModel(k, STREAM_ROWS - k) for _ in range(b)]
        for t, t0 in enumerate(stream_units(plan, cta)):
            for h in range(0, STREAM_TILE, CHUNK):
                ids = np.arange(t0 + h, min(t0 + h + CHUNK, n))  # ids >= n never pass
                if ids.size == 0:
                    continue
                for g0 in range(0, b, QUADS):
                    group = range(g0, min(g0 + QUADS, b))
                    masks = {r: rows[r].passes(scores[r, ids], ids, shared[r]) for r in group}
                    if any(len(rows[r].buf_v) + int(masks[r].sum()) > rows[r].cap for r in group):
                        for r in group:
                            rows[r].compact()
                            if rows[r].list_v.size == k:  # published at compaction
                                shared[r] = max(shared[r], rows[r].list_v[-1])
                            masks[r] = rows[r].passes(scores[r, ids], ids, shared[r])
                        if stats is not None:
                            stats.setdefault("first_overflow_tile", t)
                    for r in group:
                        rows[r].buf_v += scores[r, ids][masks[r]].tolist()
                        rows[r].buf_i += ids[masks[r]].tolist()
        for r, row in enumerate(rows):
            lists_v[cta, r], lists_i[cta, r] = row.finish()
    if stats is not None:
        stats["lists"] = ctas
    return merge_passes(lists_v, lists_i, k, stats)


def _masked(vals, ids):
    return np.where(ids < 0, 0.0, vals).astype(np.float32), ids.astype(np.int32)


def _near_tie(vals, ids, ref_vals, ref_ids):
    np.testing.assert_allclose(vals, np.asarray(ref_vals), rtol=0, atol=ATOL)
    assert_ranking_close(vals, ids, np.asarray(ref_vals), np.asarray(ref_ids), rtol=0, atol=TIE)


# ---- the model against the twin and the JAX kernel --------------------------


@pytest.mark.parametrize("share", [True, False])
@pytest.mark.parametrize("b", [7, 40])  # 16-row query tiles, 64-row
@pytest.mark.parametrize("k", [1, 10, 32])
def test_model_matches_twin_and_pallas(b, k, share):
    emb = synthetic_embeddings(5_000, dim=64, seed=61)
    q, _ = synthetic_query_embeddings(emb, b, seed=62)
    plan = T.fused_plan(b, 5_000, k)
    stats = {}
    mv, mi = _masked(*v2_model(emb, q, k, plan, stats, share=share))
    pv, pi = T.fused_topk_plain(torch.from_numpy(emb), torch.from_numpy(q), k)
    _near_tie(mv, mi, pv.numpy(), pi.numpy())
    jv, ji = J.dense_topk_pallas(
        jnp.asarray(emb), jnp.asarray(q), k=k, block_q=8, block_c=512, interpret=True
    )
    _near_tie(mv, mi, np.asarray(jv), np.asarray(ji))
    # > 32 splits: the merge runs in two passes
    assert plan["n_split"] > 32 and stats["passes"] == 2


def test_model_k_1024_and_bf16_rows():
    """k = 1,024 (sort width 2,048) on bf16-valued rows, widened exactly."""
    emb = synthetic_embeddings(3_000, dim=32, seed=63)
    q, _ = synthetic_query_embeddings(emb, 5, seed=64)
    emb = torch.from_numpy(emb).bfloat16().float().numpy()
    q = torch.from_numpy(q).bfloat16().float().numpy()
    plan = T.fused_plan(5, 3_000, 1_024)
    assert plan["sort_len"] == 2_048
    mv, mi = _masked(*v2_model(emb, q, 1_024, plan))
    pv, pi = T.fused_topk_plain(
        torch.from_numpy(emb).bfloat16(), torch.from_numpy(q).bfloat16(), 1_024
    )
    _near_tie(mv, mi, pv.numpy(), pi.numpy())


def test_model_k_beyond_n_docs():
    emb = synthetic_embeddings(20, dim=32, seed=65)
    q, _ = synthetic_query_embeddings(emb, 3, seed=66)
    plan = T.fused_plan(3, 20, 32)
    assert plan["n_split"] == 1
    mv, mi = _masked(*v2_model(emb, q, 32, plan))
    assert (mi[:, 20:] == -1).all() and (mv[:, 20:] == 0).all()
    pv, pi = T.fused_topk_plain(torch.from_numpy(emb), torch.from_numpy(q), 32)
    _near_tie(mv, mi, pv.numpy(), pi.numpy())
    jv, ji = J.dense_topk_pallas(
        jnp.asarray(emb), jnp.asarray(q), k=32, block_q=8, block_c=128, interpret=True
    )
    _near_tie(mv, mi, np.asarray(jv), np.asarray(ji))


@pytest.mark.parametrize("b", [8, 24])
def test_model_duplicate_rows_lower_id_first(b):
    """Doc i and doc i + 700 are equal rows across many splits: each pair
    comes out together, the lower id first, exactly as the twin has it."""
    base = synthetic_embeddings(700, dim=32, seed=67)
    emb = np.concatenate([base, base])
    q = base[:b]
    plan = T.fused_plan(b, 1_400, 10)
    mv, mi = _masked(*v2_model(emb, q, 10, plan))
    pv, pi = T.fused_topk_plain(torch.from_numpy(emb), torch.from_numpy(q), 10)
    np.testing.assert_array_equal(mi, pi.numpy())
    assert (mi[:, 0] == np.arange(b)).all() and (mi[:, 1] == np.arange(b) + 700).all()


def test_buffer_overflows_on_the_first_tile():
    """Every score of the first 128-doc tile beats the empty list's
    threshold, so the buffer (54 keys at k = 10) overflows inside the first
    tile and is compacted there."""
    emb = synthetic_embeddings(2_000, dim=32, seed=68)
    q, _ = synthetic_query_embeddings(emb, 4, seed=69)
    plan = dict(T.fused_plan(4, 2_000, 10), n_split=1, split_len=2_048)
    assert plan["nt"] == 128 > plan["cap"]
    stats = {}
    mv, mi = _masked(*v2_model(emb, q, 10, plan, stats))
    assert stats["first_overflow_tile"] == 0 and stats["compactions"] > 4
    pv, pi = T.fused_topk_plain(torch.from_numpy(emb), torch.from_numpy(q), 10)
    _near_tie(mv, mi, pv.numpy(), pi.numpy())


@pytest.mark.parametrize(
    "b,n,k", [(1, 20, 1), (15, 20_000, 10), (256, 20_000, 32), (256, 98_304, 32),
              (300, 98_304, 1_024), (1, 98_304, 1_024)]
)
def test_fused_plan_covers_the_corpus_and_fills_the_card(b, n, k):
    plan = T.fused_plan(b, n, k, sms=132)
    qt, nt = plan["qt"], plan["nt"]
    assert qt == (64 if b > 16 and k <= 32 else 16) and nt == T._FUSED_TILE_DOCS
    assert plan["split_len"] % nt == 0
    assert (plan["n_split"] - 1) * plan["split_len"] < n <= plan["n_split"] * plan["split_len"]
    sort_len = plan["sort_len"]
    assert sort_len & (sort_len - 1) == 0 and sort_len >= k + plan["cap"] > sort_len // 2
    blocks = -(-b // qt) * plan["n_split"]
    # a wave of blocks where the tiles allow, less the rounding to whole tiles
    wave = T._FUSED_BLOCKS_PER_SM[qt] * 132
    assert blocks >= 0.9 * min(wave, -(-b // qt) * -(-n // nt))


# ---- the stream route (bf16 rows, k <= 32) ----------------------------------


def _bf16_valued(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.mark.parametrize("b,k", [(5, 1), (5, 10), (5, 32), (130, 10)])  # 130: two query tiles
def test_stream_model_matches_twin_and_pallas(b, k):
    emb = _bf16_valued(synthetic_embeddings(20_000, dim=32, seed=77))
    q, _ = synthetic_query_embeddings(emb, b, seed=78)
    q = _bf16_valued(q)
    stats = {}
    mv, mi = _masked(*stream_model(emb, q, k, stats=stats))
    pv, pi = T.fused_topk_plain(
        torch.from_numpy(emb).bfloat16(), torch.from_numpy(q).bfloat16(), k
    )
    _near_tie(mv, mi, pv.numpy(), pi.numpy())
    jv, ji = J.dense_topk_pallas(
        jnp.asarray(emb), jnp.asarray(q), k=k, block_q=8, block_c=512, interpret=True
    )
    _near_tie(mv, mi, np.asarray(jv), np.asarray(ji))
    assert stats["lists"] > 32 and stats["passes"] == 2  # > 32 lists: two merge passes


def test_stream_model_k_beyond_n_docs_and_duplicates():
    """N = 20 (k > N; most blocks walk only docs past the end and leave
    empty lists), and doc i == doc i + 3,000 (lower id first, exactly)."""
    emb = _bf16_valued(synthetic_embeddings(20, dim=32, seed=79))
    q = emb[:3]
    mv, mi = _masked(*stream_model(emb, q, 32))
    assert (mi[:, 20:] == -1).all() and (mv[:, 20:] == 0).all()
    pv, pi = T.fused_topk_plain(torch.from_numpy(emb), torch.from_numpy(q), 32)
    _near_tie(mv, mi, pv.numpy(), pi.numpy())
    base = _bf16_valued(synthetic_embeddings(3_000, dim=32, seed=80))
    emb = np.concatenate([base, base])
    q = base[:6]
    mv, mi = _masked(*stream_model(emb, q, 10))
    pv, pi = T.fused_topk_plain(torch.from_numpy(emb), torch.from_numpy(q), 10)
    np.testing.assert_array_equal(mi, pi.numpy())
    assert (mi[:, 0] == np.arange(6)).all() and (mi[:, 1] == np.arange(6) + 3_000).all()


def test_stream_buffer_overflows_on_the_first_tile():
    """At k = 10 the buffer holds 54: the first tile's 64 scores all beat
    the empty list, so its second ballot overflows and compacts."""
    emb = _bf16_valued(synthetic_embeddings(2_000, dim=32, seed=81))
    q, _ = synthetic_query_embeddings(emb, 4, seed=82)
    stats = {}
    mv, mi = _masked(*stream_model(emb, _bf16_valued(q), 10, sms=1, stats=stats))
    assert stats["lists"] == 1 and stats["first_overflow_tile"] == 0
    pv, pi = T.fused_topk_plain(torch.from_numpy(emb), torch.from_numpy(_bf16_valued(q)), 10)
    _near_tie(mv, mi, pv.numpy(), pi.numpy())


@pytest.mark.parametrize(
    "b,n,want", [(15, 20_000, (16, 64)), (256, 98_304, (16, 66)), (300, 98_304, (16, 44)),
                 (1, 20, (16, 32)), (256, 1_250_000, (2, 66))]
)
def test_stream_plan_covers_the_corpus_once(b, n, want):
    """(parts, lists a query) as plan_grid of csrc/tma_stream.cuh has them,
    and the blocks of a query tile walk every 64-doc tile of the supers
    exactly once."""
    plan = T.fused_stream_plan(b, n, sms=132)
    assert (plan["parts"], plan["ctas_per_qt"]) == want
    seen = np.concatenate([
        np.fromiter(stream_units(plan, c), np.int64) for c in range(plan["ctas_per_qt"])
    ])
    assert np.array_equal(np.sort(seen), np.arange(0, plan["n_super"] * T._TURBO_UNIT, STREAM_TILE))


# ---- feature padding (F1) ---------------------------------------------------


def test_pad_features():
    x = torch.arange(30, dtype=torch.float32).view(3, 10)
    y = T.pad_features(x)
    assert y.shape == (3, 16) and torch.equal(y[:, :10], x) and (y[:, 10:] == 0).all()
    assert T.pad_features(y) is y  # no copy once aligned
    assert T.pad_features(x, 40).shape == (3, 40)
    assert T.padded_dim(100) == 112 and T.padded_dim(384) == 384
    with pytest.raises(ValueError, match="down"):
        T.pad_features(y, 8)
    q8 = torch.ones((2, 3, 100), dtype=torch.int8)
    assert T.pad_features(q8).shape == (2, 3, 112) and T.pad_features(q8).dtype == torch.int8


def test_pad_corpus_rows_pads_both_axes():
    x = torch.arange(30, dtype=torch.float32).view(3, 10)
    y = T.pad_corpus_rows(x, 16)
    assert y.shape == (T._TURBO_UNIT, 16) and torch.equal(y[:3, :10], x)
    assert not y[3:].any() and not y[:, 10:].any()
    assert T.pad_corpus_rows(x).shape == (T._TURBO_UNIT, 10)
    assert T.pad_corpus_rows(y, 16) is y  # no copy once aligned


@pytest.mark.parametrize("dim", [100, 200])
def test_corpora_are_padded_once(dim):
    rows = torch.from_numpy(synthetic_embeddings(1_000, dim=dim, seed=70))
    width = T.padded_dim(dim)
    i8, i4 = convert.int8_corpus(rows), convert.int4_corpus(rows)
    fast, fused = convert.fast_corpus(rows), convert.fused_corpus(rows)
    assert i8.shape == (T._TURBO_UNIT, width) and i4.shape == (T._TURBO_UNIT // 2, width)
    assert fast.shape == (T._TURBO_UNIT, width) and fused.shape == (1_000, width)
    assert torch.equal(i8[:1_000, :dim], T.quantize_int8(rows)) and not i8[:, dim:].any()
    assert torch.equal(i4, T.pad_features(T.pack_corpus_i4(T.quantize_int4(rows))))
    assert torch.equal(fast[:1_000, :dim], rows) and not fast[:, dim:].any()
    assert torch.equal(fused[:, :dim], rows) and not fused[:, dim:].any()


@pytest.fixture(scope="module")
def padded_operands():
    rng = np.random.default_rng(71)
    n, dim, b = 2 * T._TURBO_UNIT + 300, 100, 32
    emb, q = dyadic_rows(rng, n, dim), dyadic_rows(rng, b, dim)
    return emb, q


@pytest.mark.parametrize("kernel", ["A", "C1", "C2", "D", "E1", "E2", "S"])
def test_padded_cells_equal_unpadded(padded_operands, kernel):
    """Each candidate twin on zero-padded features (D 100 -> 112) gives the
    cells of the unpadded operands, bit for bit."""
    emb, q = (torch.from_numpy(x) for x in padded_operands)
    e8, q8 = T.pad_corpus_rows(T.quantize_int8(emb)), T.quantize_int8(q)
    e4 = T.pack_corpus_i4(T.quantize_int4(emb))
    rows = T.pad_corpus_rows(emb)
    cells = {
        "A": lambda c, x: T.i8_top2g_cells_plain(x, c, group=2, sub=64),
        "C1": lambda c, x: T.i8_turbo_cells_plain(x, c, slots=1),
        "C2": lambda c, x: T.i8_turbo_cells_plain(x, c, slots=2),
        "D": lambda c, x: T.fast_cells_plain(x, c),
        "E1": lambda c, x: T.i4_cells_plain(x, c, slots=1),
        "E2": lambda c, x: T.i4_cells_plain(x, c, slots=2),
        "S": lambda c, x: T.dot_only_plain(x, c),
    }[kernel]
    corpus, queries = {"D": (rows, q), "E1": (e4, q8), "E2": (e4, q8)}.get(kernel, (e8, q8))
    want = cells(corpus, queries)
    got = cells(T.pad_features(corpus), T.pad_features(queries))
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)


def test_public_ops_pad_a_misfit_width(padded_operands):
    """The public ops take rows of any width and pad them per call; a
    corpus padded at load and unpadded queries give the same answer."""
    emb, q = (torch.from_numpy(x) for x in padded_operands)
    n = emb.shape[0]
    e8, q8 = T.pad_corpus_rows(T.quantize_int8(emb)), T.quantize_int8(q)
    pairs = [
        (lambda c, x: T.dense_topk_fast_i8_grouped(c, x, k=32, n_docs=n), e8, q8),
        (lambda c, x: T.dense_topk_fast_i8(c, x, k=32, n_docs=n), e8, q8),
        (lambda c, x: T.dense_topk_fast(c, x, k=32, n_docs=n), T.pad_corpus_rows(emb), q),
        (lambda c, x: T.dense_topk_fast_i4(c, x, k=64, n_docs=n),
         T.pack_corpus_i4(T.quantize_int4(emb)), q8),
        (lambda c, x: (T.dot_only(c, x),), e8, q8),
        (lambda c, x: T.dense_topk_pallas(c, x, k=32), emb, q),
    ]
    for op, corpus, queries in pairs:
        want = op(corpus, queries)
        for got in (op(T.pad_features(corpus), queries), op(T.pad_features(corpus), T.pad_features(queries))):
            for g, w in zip(got, want):
                assert torch.equal(g, w)


@pytest.mark.parametrize("dim", [1_536, 2_048])
def test_wrappers_accept_wide_rows(dim):
    """Kernel B takes any width (the card kernel streams K; the twin on the
    CPU): D = 1,536 and 2,048 at k = 1,024."""
    emb = synthetic_embeddings(1_200, dim=dim, seed=72)
    q, _ = synthetic_query_embeddings(emb, 3, seed=73)
    vals, ids = T.dense_topk_pallas(torch.from_numpy(emb), torch.from_numpy(q), k=1_024)
    assert ids.shape == (3, 1_024) and (ids[:, 0] >= 0).all()
    rv, ri = T.fused_topk_plain(torch.from_numpy(emb), torch.from_numpy(q), 1_024)
    assert torch.equal(ids, ri) and torch.equal(vals, rv)


@pytest.mark.parametrize("dim", [100, 200])
@pytest.mark.parametrize("kernel", ["int8", "fast", "int4", "pallas"])
def test_hybrid_at_a_misfit_width_equals_the_unpadded_path(monkeypatch, kernel, dim):
    """``HybridRetriever(device="cpu")`` with each arm forced, at D = 100 and
    200: the padded corpora and queries give exactly the results of the same
    path with padding turned off (dyadic rows: every sum exact)."""
    rng = np.random.default_rng(74)
    n = 3_000
    index = synthetic_postings_index(n, vocab_size=500, seed=75)
    emb = dyadic_rows(rng, n, dim)
    q = dyadic_rows(rng, 20, dim)
    term_ids = [list(rng.integers(20, 500, size=3)) for _ in range(20)]

    def run():
        dense = DenseIndex(embeddings=torch.from_numpy(emb), n_docs=n, dim=dim)
        retr = HybridRetriever(index, dense, kernel=kernel, device="cpu", device_batch=8)
        return retr, retr.search_prepared(term_ids, q, k=10, candidates_per_arm=32)

    retr, got = run()
    assert retr.dense._emb_device.shape[1] == T.padded_dim(dim) > dim
    monkeypatch.setattr(T, "FEATURE_MULTIPLE", 1)
    retr, want = run()
    assert retr.dense._emb_device.shape[1] == dim
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)


def order_key(x: np.ndarray) -> np.ndarray:
    """``order_key`` of ``csrc/fused_topk_v2.cu`` on float32 scores."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def test_shared_threshold_keys_keep_the_score_order():
    """The splits publish their k-th score as an unsigned key by atomicMax:
    keys order as the scores do, negative ones and -inf included, and the
    zero the buffer starts at lies below every score."""
    rng = np.random.default_rng(76)
    x = np.concatenate([
        rng.standard_normal(2_000).astype(np.float32),
        np.float32([-np.inf, np.inf, 0.0, -0.0, 1e-38, -1e-38, 3e38, -3e38]),
    ])
    keys = order_key(x)
    order = np.argsort(x, kind="stable")
    xs, ks = x[order], keys[order].astype(np.int64)
    strict = xs[1:] > xs[:-1]  # -0.0 and 0.0 compare equal; their keys may not
    assert (ks[1:][strict] > ks[:-1][strict]).all()
    assert (keys > 0).all()
    back = np.where(keys & 0x80000000, keys & 0x7FFFFFFF, ~keys).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(back, x)
