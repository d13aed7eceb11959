"""The port's CUDA kernels against their plain twins, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker and
skip without a card. They import no jax; run them on a machine with an
NVIDIA card (sm_90a) and nvcc:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

Tolerances: the cells of kernels A, C1, C2, E1 and E2 and the lane sums of
kernel S (on the stream and its v1 control) are bit-identical to the
twins' (integer arithmetic); kernel D's
are too on dyadic operands (every
partial sum exact), and elsewhere a cell's score moves by at most one step
of 2**-15 (the sum order); kernel B's scores (v2, ``csrc/fused_topk_v2.cu``:
its ``cp.async`` ring and, for bf16 rows at k <= 32, its TMA + wgmma
stream route; and its v1 control) agree to 2e-6 and its ids are equal
except where two docs' scores differ by less than 1e-5 (the twin sums in
another order; bf16 products are exact in float32, summed by the tensor
cores), and duplicate rows come out lower id first, exactly. The
redesigned kernels A, B (bf16: the stream route against the ring), C1, C2,
D, E1, E2 and S (TMA + wgmma) are also held to their A/B controls (their
``mma.sync`` versions) under the same rules. The port's pipelined serving
on the card equals the sequential path, bit for bit, filtered waves too;
every arm's filtered path equals its plain-twin path on dyadic rows. The hybrid paths at D = 100
and 200 (feature axis zero-padded to 112 and 208) equal their plain-twin
paths on dyadic rows, for every arm. The encoder at the CLI's default
width encodes on the card as the port does on the CPU (f32 within 1e-5,
bf16 within 2e-2), and kernels A (bit for bit) and B (its rule) hold to
their twins on the encoder's 256-wide rows. The reranked search (ROADMAP
item 12) runs its first stage through kernel A (int8) or B (pallas) and
scores its pairs on the card as the port does on the CPU (f32 within
1e-5, bf16 within 2e-2; the reordered ids equal but at near-ties); the
lexicon's device path equals its NumPy twin bit for bit; the neural
analyzer's logits, ``aggregate_batch`` and ``atr_batch`` on the card equal
their CPU runs (integer columns and codes equal, floats within 1e-5 and
1e-6).
"""

import functools

import numpy as np
import pytest
import torch
from torch_dense_utils import QUANTUM, assert_quantum_rule, dyadic_rows

from openintel_tpu_torch import convert
from openintel_tpu_torch.index.schema import DenseIndex
from openintel_tpu_torch.index.synthetic import (
    synthetic_embeddings,
    synthetic_postings_index,
    synthetic_query_embeddings,
)
from openintel_tpu_torch.models.retrievers import HybridRetriever, dense_arm_topk
from openintel_tpu_torch.ops import dense_topk as T
from openintel_tpu_torch.ops.dense import require_true_f32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    require_true_f32()
    return torch.device("cuda")


@pytest.mark.parametrize(
    "group,block_c,dim",
    # dim 32: half a k chunk (a quarter TMA box); 640: two passes of five
    # chunks (five boxes); 2048: queries streamed with each doc box.
    # block_c 128, 256, 16384: one, two and 128 sub-blocks per step
    [(1, 8192, 128), (2, 4096, 128), (3, 8192, 128), (2, 8192, 32), (3, 4096, 640),
     (2, 128, 128), (3, 256, 128), (1, 16384, 384), (2, 8192, 2048),
     # group 5, the filtered path's at 1.25M docs: here 7 supers, the last
     # group of 2
     (5, 8192, 128), (5, 4096, 384)],
)
def test_kernel_a_cells_match_twin(cuda, group, block_c, dim):
    """Kernel A (TMA + wgmma, two stages) bit for bit against its twin."""
    n = 6 * T._TURBO_UNIT + 123  # 7 supers: a short last group and super
    emb = synthetic_embeddings(n, dim=dim, seed=1)
    corpus = convert.int8_corpus(torch.from_numpy(emb).to(cuda))
    q, _ = synthetic_query_embeddings(emb, 64, seed=2)
    q8 = T.quantize_int8(torch.from_numpy(q)).to(cuda)
    before = T.launch_counts()["i8_top2g"]
    got = T.i8_top2g_cells(q8, corpus, group=group, sub=block_c // 128)
    want = T.i8_top2g_cells_plain(q8, corpus, group=group, sub=block_c // 128)
    torch.cuda.synchronize()
    assert T.launch_counts()["i8_top2g"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _assert_b_rule(got, want):
    """Kernel B's rule: scores within 2e-6 where the ids agree; ids differ
    only where the two docs' scores differ by less than 1e-5."""
    kv, ki, pv, pi = (t.cpu().numpy() for t in (*got, *want))
    assert ki.shape == pi.shape
    same = ki == pi
    np.testing.assert_allclose(kv[same], pv[same], rtol=0, atol=2e-6)
    assert (np.abs(kv - pv)[~same] < 1e-5).all()
    for row in ki:
        real = row[row >= 0]
        assert len(set(real.tolist())) == real.size


@functools.lru_cache(maxsize=2)
def _unit_rows(n, dim, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, dim), generator=g, device="cuda")
    return x / x.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("dim", [96, 100, 384, 1536, 2048])  # 100: padded to 112
@pytest.mark.parametrize("k", [1, 10, 32, 100, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_b_matches_twin(cuda, dtype, k, dim):
    """Kernel B v2 at B 1, 15 (16-row query tiles), 256 and 300 (64-row),
    over N 20 (k > N: (0.0, -1) slots), 9,000 and 98,304."""
    docs = _unit_rows(98_304, dim, 3).to(dtype)
    queries = _unit_rows(300, dim, 4).to(dtype)
    for n in (20, 9_000, 98_304):
        for b in (1, 15, 256, 300):
            d, q = docs[:n], queries[:b]
            before = T.launch_counts()["fused_topk"]
            got = T.fused_topk(d, q, k)
            torch.cuda.synchronize()
            assert T.launch_counts()["fused_topk"] == before + 1
            _assert_b_rule(got, T.fused_topk_plain(d, q, k))
            if k > n:
                assert (got[1][:, n:] == -1).all() and (got[0][:, n:] == 0).all()


@pytest.mark.parametrize("b", [1, 15, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_b_duplicate_rows_lower_id_first(cuda, dtype, b):
    """Doc i equals doc i + 4,500: each pair comes out together with equal
    scores, lower id first, at every rank (the twin's product need not give
    both rows of a pair the same rounding, so it is held to the rule)."""
    base = _unit_rows(4_500, 384, 5).to(dtype)
    docs = torch.cat([base, base])
    q = base[torch.arange(b, device=cuda) * 7 % 4_500]
    routes = ("ring", "stream") if dtype == torch.bfloat16 else ("ring",)
    for route in routes:  # bf16: the TMA + wgmma stream as well
        kv, ki = T.fused_topk(docs, q, 10, route=route)
        _assert_b_rule((kv, ki), T.fused_topk_plain(docs, q, 10))
        assert torch.equal(ki[:, 1::2] - ki[:, 0::2], torch.full_like(ki[:, 0::2], 4_500))
        assert torch.equal(kv[:, 1::2], kv[:, 0::2])
        assert (ki[:, 0] == torch.arange(b, device=cuda) * 7 % 4_500).all()


@pytest.mark.parametrize("dim", [100, 384, 1536])  # 1536: queries streamed
@pytest.mark.parametrize("b", [1, 15, 256, 300])  # 256: 2-block clusters; 300: 3 tiles
def test_kernel_b_bf16_stream_against_ring(cuda, b, dim):
    """bf16 rows at k <= 32 also run on the TMA + wgmma stream
    (``route="stream"``), held to the served ring: both under the rule
    against the twin and against each other, at k 1, 10 and 32 over N 20
    (k > N: (0.0, -1) slots), 9,000 and 98,304."""
    docs = _unit_rows(98_304, dim, 8).bfloat16()
    q = _unit_rows(300, dim, 9).bfloat16()[:b]
    for n in (20, 9_000, 98_304):
        for k in (1, 10, 32):
            d = docs[:n]
            T.reset_launch_counts()
            got, ring = T.fused_topk(d, q, k, route="stream"), T.fused_topk(d, q, k)
            torch.cuda.synchronize()
            assert T.launch_counts()["fused_topk"] == 2
            want = T.fused_topk_plain(d, q, k)
            _assert_b_rule(got, want)
            _assert_b_rule(ring, want)
            _assert_b_rule(got, ring)
            if k > n:
                assert (got[1][:, n:] == -1).all() and (got[0][:, n:] == 0).all()


@pytest.mark.parametrize("k", [10, 32])
@pytest.mark.parametrize("b", [1, 15, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_b_new_against_v1(cuda, dtype, b, k):
    """At a width v1 takes (D=384, N=20,000): v2 and its v1 control both
    under the rule against the twin, and against each other; each launch
    counted apart."""
    docs = _unit_rows(20_000, 384, 6).to(dtype)
    q = _unit_rows(256, 384, 7).to(dtype)[:b]
    T.reset_launch_counts()
    got, v1 = T.fused_topk(docs, q, k), T.fused_topk_v1(docs, q, k)
    torch.cuda.synchronize()
    assert {n: c for n, c in T.launch_counts().items() if c} == {"fused_topk": 1, "fused_topk_v1": 1}
    want = T.fused_topk_plain(docs, q, k)
    _assert_b_rule(got, want)
    _assert_b_rule(v1, want)
    _assert_b_rule(got, v1)


def test_hybrid_int8_path_matches_twins(cuda):
    n = 40_000
    index = synthetic_postings_index(n, vocab_size=2_000, seed=5)
    emb = synthetic_embeddings(n, dim=64, seed=6)
    retr = HybridRetriever(
        index, DenseIndex.from_embeddings(emb, dtype=torch.bfloat16), kernel="int8",
        device=cuda, device_batch=32,
    )
    rng = np.random.default_rng(7)
    term_ids = [list(rng.integers(20, 2_000, size=3)) for _ in range(70)]
    q, _ = synthetic_query_embeddings(emb, 70, seed=8)
    prep = retr.prepare(term_ids, q, k=10, candidates_per_arm=32)
    T.reset_launch_counts()
    got = retr.finalize_prepared(prep, retr.run_prepared_device(prep))
    assert T.launch_counts()["i8_top2g"] == 3
    want = retr.finalize_prepared(prep, retr.run_prepared_device(prep, plain=True))
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [64, 384, 1024])  # bf16 1024: queries streamed
def test_kernel_d_cells_match_twin(cuda, dtype, dim):
    """Dyadic operands: cells bit-identical. Random unit rows: each cell's
    score within one step, its position equal unless the twin's two docs
    score within a step of each other."""
    n = 2 * T._TURBO_UNIT + 5_000  # 3 supers, the last one short
    rng = np.random.default_rng(11)
    q = torch.from_numpy(dyadic_rows(rng, 64, dim)).to(cuda, dtype)
    corpus = T.pad_corpus_rows(torch.from_numpy(dyadic_rows(rng, n, dim)).to(cuda, dtype))
    before = T.launch_counts()["turbo_f32"]
    got = T.fast_cells(q, corpus)
    torch.cuda.synchronize()
    assert T.launch_counts()["turbo_f32"] == before + 1
    assert torch.equal(got, T.fast_cells_plain(q, corpus))

    emb = synthetic_embeddings(n, dim=dim, seed=12)
    qr, _ = synthetic_query_embeddings(emb, 64, seed=13)
    q = torch.from_numpy(qr).to(cuda, dtype)
    corpus = T.pad_corpus_rows(torch.from_numpy(emb).to(cuda, dtype))
    got, want = T.fast_cells(q, corpus), T.fast_cells_plain(q, corpus)
    decode = lambda c: (c & ~127).view(torch.float32).double()  # noqa: E731
    assert (decode(got) - decode(want)).abs().max() <= QUANTUM
    scores = (q.float() @ corpus.float().T).view(64, 3, 128, 128)
    pick = lambda c: scores.gather(2, (c & 127).long().view(64, 3, 1, 128))  # noqa: E731
    moved = (got & 127) != (want & 127)
    gap = (pick(got) - pick(want)).abs().view(64, -1)
    assert (gap[moved] <= QUANTUM).all()


@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_kernel_e_cells_match_twin(cuda, slots, data):
    n = 2 * T._TURBO_UNIT + 5_001  # ragged: the last doc pairs with padding
    rng = np.random.default_rng(14)
    if data == "ties":  # nibbles and queries in {-1, 0, 1}
        e4 = torch.from_numpy(rng.integers(-1, 2, (n, 384)).astype(np.int8))
        q8 = torch.from_numpy(rng.integers(-1, 2, (64, 384)).astype(np.int8))
    else:
        emb = synthetic_embeddings(n, dim=384, seed=15)
        e4 = T.quantize_int4(torch.from_numpy(emb))
        q8 = T.quantize_int8(torch.from_numpy(synthetic_query_embeddings(emb, 64, seed=16)[0]))
    packed = T.pack_corpus_i4(e4).to(cuda)
    q8 = q8.to(cuda)
    name = "turbo_i4_top2" if slots == 2 else "turbo_i4"
    before = T.launch_counts()[name]
    got = T.i4_cells(q8, packed, slots=slots)
    torch.cuda.synchronize()
    assert T.launch_counts()[name] == before + 1
    assert torch.equal(got, T.i4_cells_plain(q8, packed, slots=slots))
    kv, ki = T.dense_topk_fast_i4(packed, q8[:45], k=300, n_docs=n, slots=slots)
    pv, pi = T.dense_topk_fast_i4(packed, q8[:45], k=300, n_docs=n, slots=slots, plain=True)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


def _hybrid_pair(cuda, kernel, emb):
    n = emb.shape[0]
    index = synthetic_postings_index(n, vocab_size=2_000, seed=5)
    rows = torch.from_numpy(emb).to(torch.bfloat16)
    dense = DenseIndex(embeddings=rows, n_docs=n, dim=emb.shape[1])
    return HybridRetriever(index, dense, kernel=kernel, device=cuda, device_batch=32)


def _run_both(retr, q, counter, **filters):
    rng = np.random.default_rng(7)
    term_ids = [list(rng.integers(20, 2_000, size=3)) for _ in range(q.shape[0])]
    prep = retr.prepare(term_ids, q, k=10, candidates_per_arm=32, **filters)
    T.reset_launch_counts()
    got = retr.finalize_prepared(prep, retr.run_prepared_device(prep))
    assert T.launch_counts()[counter] == prep.queries.shape[0]
    want = retr.finalize_prepared(prep, retr.run_prepared_device(prep, plain=True))
    return got, want


def _assert_pools_equal(retr, q, **filters):
    """Each sub-batch's over-fetched dense pool, before the compaction,
    equals its plain pool bit for bit (dyadic rows: every sum exact; int4:
    all of E2's wider fetch, rescored). A starved query's result is the
    fallback's on both sides of ``_run_both``, so the pools are what hold
    the kernel at ``c_fetch``."""
    term_ids = [[20]] * q.shape[0]
    prep = retr.prepare(term_ids, q, k=10, candidates_per_arm=32, **filters)
    dense, width = retr.dense, prep.c_fetch
    keep = min(max(4 * width, 256), retr.n_docs) if retr.kernel == "int4" else width
    for i in range(prep.queries.shape[0]):
        got, want = (
            dense_arm_topk(
                dense.kernel, dense._emb_device, prep.queries[i], keep,
                n_docs=retr.n_docs, block_c=retr._dense_block_c(prep.queries.shape[1]),
                candidates=width, rescore_op=dense._rescore_emb,
                q8=prep.queries_i8[i], plain=plain,
            )
            for plain in (False, True)
        )
        assert got[1].shape[1] == keep
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return prep


def test_hybrid_fast_path_matches_twins(cuda):
    """Dyadic rows and queries: the kernel path equals the twin path."""
    rng = np.random.default_rng(17)
    retr = _hybrid_pair(cuda, "fast", dyadic_rows(rng, 40_000, 64))
    got, want = _run_both(retr, dyadic_rows(rng, 70, 64), "turbo_f32")
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)


def test_kernel_d_decode_random_rows_within_a_step(cuda):
    emb = synthetic_embeddings(40_000, dim=64, seed=18)
    q, _ = synthetic_query_embeddings(emb, 70, seed=19)
    corpus = convert.fast_corpus(torch.from_numpy(emb).to(cuda, torch.bfloat16))
    qq = torch.from_numpy(q).to(cuda, torch.bfloat16)
    scores = (qq.double() @ corpus[:40_000].double().T).cpu().numpy()
    for k in (32, 3 * 128 + 7):  # the second clamps and pads
        kv, ki = T.dense_topk_fast(corpus, qq, k=k, n_docs=40_000)
        pv, pi = T.dense_topk_fast(corpus, qq, k=k, n_docs=40_000, plain=True)
        assert_quantum_rule(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu(), scores)


def test_hybrid_int4_path_matches_twins(cuda):
    emb = synthetic_embeddings(40_000, dim=64, seed=20)
    retr = _hybrid_pair(cuda, "int4", emb)
    q, _ = synthetic_query_embeddings(emb, 70, seed=21)
    got, want = _run_both(retr, q, "turbo_i4_top2")
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)


@pytest.mark.parametrize("dim", [32, 384, 640])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_kernels_c_and_s_match_twins(cuda, data, dim):
    """Cells of C1 and C2, ``dense_topk_fast_i8`` and kernel S's lane sums,
    bit for bit; dim 32 is half a k chunk, 640 two passes of five."""
    n = 2 * T._TURBO_UNIT + 5_000  # 3 supers, the last one short
    rng = np.random.default_rng(22)
    if data == "ties":  # entries in {-1, 0, 1}
        e8 = torch.from_numpy(rng.integers(-1, 2, (n, dim)).astype(np.int8))
        q8 = torch.from_numpy(rng.integers(-1, 2, (64, dim)).astype(np.int8))
    else:
        emb = synthetic_embeddings(n, dim=dim, seed=23)
        e8 = T.quantize_int8(torch.from_numpy(emb))
        q8 = T.quantize_int8(torch.from_numpy(synthetic_query_embeddings(emb, 64, seed=24)[0]))
    corpus = T.pad_corpus_rows(e8.to(cuda))
    q8 = q8.to(cuda)
    for slots, name in ((1, "turbo_i8"), (2, "turbo_i8_top2")):
        T.reset_launch_counts()
        got = T.i8_turbo_cells(q8, corpus, slots=slots)
        v1 = T.i8_turbo_cells_v1(q8, corpus, slots=slots)
        torch.cuda.synchronize()
        assert {k: v for k, v in T.launch_counts().items() if v} == {name: 1, f"{name}_v1": 1}
        want = T.i8_turbo_cells_plain(q8, corpus, slots=slots)
        assert torch.equal(got, want) and torch.equal(v1, want)
        kv, ki = T.dense_topk_fast_i8(corpus, q8[:45], k=300, n_docs=n, slots=slots)
        pv, pi = T.dense_topk_fast_i8(corpus, q8[:45], k=300, n_docs=n, slots=slots, plain=True)
        assert torch.equal(ki, pi) and torch.equal(kv, pv)
    before = T.launch_counts()["dot_only"]
    got = T.dot_only(corpus, q8[:45])
    torch.cuda.synchronize()
    assert T.launch_counts()["dot_only"] == before + 1
    assert torch.equal(got, T.dot_only(corpus, q8[:45], plain=True))


@pytest.mark.parametrize("dim", [112, 384, 1536, 4096])  # 1536: queries from shared memory; 4096 streamed
@pytest.mark.parametrize("b", [45, 128, 256, 320])  # one tile; one; two (C1 paired); 3 tiles
def test_kernel_c_new_matches_twin_at_any_width(cuda, b, dim):
    """Kernels C1/C2 on the TMA + wgmma stream at any width, bit for bit,
    with 1, 2 and 16 parts per super (C1's met by atomicMax, C2's by the
    merge kernel). Up to D=384 the operands are uniform int8; wider rows
    are quantised unit rows, so the twin's float32 sums stay exact
    (|dot| <= 127**2 < 2**24)."""
    n = T._TURBO_UNIT + 5_000  # 2 supers, the last one short
    rng = np.random.default_rng(35)
    if dim <= 384:
        e8 = torch.from_numpy(rng.integers(-128, 128, (n, dim)).astype(np.int8))
        q8 = torch.from_numpy(rng.integers(-128, 128, (b, dim)).astype(np.int8))
    else:
        emb = synthetic_embeddings(n, dim=dim, seed=36)
        e8 = T.quantize_int8(torch.from_numpy(emb))
        q8 = T.quantize_int8(torch.from_numpy(synthetic_query_embeddings(emb, b, seed=37)[0]))
    corpus = T.pad_corpus_rows(e8.to(cuda))
    q = T._pad_query_rows(q8.to(cuda), 32).contiguous()
    for slots, name in ((1, "turbo_i8"), (2, "turbo_i8_top2")):
        want = T.i8_turbo_cells_plain(q, corpus, slots=slots)
        T.reset_launch_counts()
        for max_parts in (1, 2, 16):
            got = T.i8_turbo_cells(q, corpus, slots=slots, max_parts=max_parts)
            assert torch.equal(got, want), (slots, max_parts)
        torch.cuda.synchronize()
        assert {k: v for k, v in T.launch_counts().items() if v} == {name: 3}


@pytest.mark.parametrize("dim", [112, 384, 1536])  # 1536: queries from shared memory
@pytest.mark.parametrize("b", [45, 128, 256, 320])  # one tile; one; two (paired); 3 tiles
@pytest.mark.parametrize("data", ["random", "saturated"])
def test_kernel_s_new_and_v1_match_twin(cuda, data, b, dim):
    """Kernel S on the TMA + wgmma stream, paired and unpaired, and its v1
    control, bit for bit; all -128 operands make the lane sums wrap. The
    twin of the stream's order of adds (runs of in-place sums, the two
    sets met by unsigned adds) agrees, with no run past int32."""
    n = T._TURBO_UNIT + 5_000  # 2 supers, the last one short
    rng = np.random.default_rng(41)
    if data == "saturated":
        e8 = torch.full((n, dim), -128, dtype=torch.int8)
        q8 = torch.full((b, dim), -128, dtype=torch.int8)
    else:
        e8 = torch.from_numpy(rng.integers(-128, 128, (n, dim)).astype(np.int8))
        q8 = torch.from_numpy(rng.integers(-128, 128, (b, dim)).astype(np.int8))
    corpus = T.pad_corpus_rows(e8.to(cuda))
    q = T._pad_query_rows(q8.to(cuda), 32).contiguous()
    want = T.dot_only_plain(q, corpus)
    T.reset_launch_counts()
    for paired in (True, False):
        assert torch.equal(T.dot_only_cells(q, corpus, paired=paired), want), paired
    assert torch.equal(T.dot_only_cells_v1(q, corpus), want)
    torch.cuda.synchronize()
    assert {k: v for k, v in T.launch_counts().items() if v} == {"dot_only": 2, "dot_only_v1": 1}
    runs, overflows = T.dot_only_runs_plain(q, corpus, parts=1)
    assert torch.equal(runs, want) and overflows == 0


def test_kernel_s_adds_wrap_past_int32_in_the_tensor_cores(cuda):
    """Runs forced to 128 sub-blocks (one part a super) at D=4096 over all
    -128 operands: each accumulator set's run sum is 2**32, past int32. The
    kernel still equals the twin, so wgmma's s32 adds wrap (the served
    runs never overflow, ``dot_only_run``)."""
    corpus = torch.full((T._TURBO_UNIT, 4096), -128, dtype=torch.int8, device=cuda)
    q8 = torch.full((32, 4096), -128, dtype=torch.int8, device=cuda)
    want = T.dot_only_plain(q8, corpus)
    _, overflows = T.dot_only_runs_plain(q8, corpus, parts=1, run_cap=128)
    assert overflows > 0
    assert torch.equal(T.dot_only_cells(q8, corpus, run_cap=128), want)
    assert torch.equal(T.dot_only_cells(q8, corpus), want)


def test_pipelined_serving_on_the_card_matches_sequential(cuda):
    """The port's PipelinedSearcher over an int8 hybrid retriever on the
    card: staging on the producer's stream, copies back through pinned
    buffers; every wave bit-identical to prepare -> run_prepared, kernel A
    once per sub-batch."""
    from openintel_tpu_torch.serving import PipelinedSearcher

    n, dim = 3 * T._TURBO_UNIT, 128
    rng = np.random.default_rng(43)
    index = synthetic_postings_index(n, vocab_size=2_000, seed=44)
    emb = synthetic_embeddings(n, dim=dim, seed=45)
    retr = HybridRetriever(
        index, DenseIndex.from_embeddings(emb, dtype=torch.bfloat16), kernel="int8",
        device=cuda, device_batch=64,
    )
    waves = []
    for _ in range(5):
        term_ids = [list(rng.integers(20, 2_000, size=3)) for _ in range(128)]
        waves.append((term_ids, synthetic_query_embeddings(emb, 128, seed=int(rng.integers(1 << 30)))[0]))
    want = [retr.run_prepared(retr.prepare(*w, k=10, candidates_per_arm=32)) for w in waves]
    T.reset_launch_counts()
    pipe = PipelinedSearcher(retr, depth=2)
    got = list(pipe.run_prepared_stream(iter(waves), k=10, candidates_per_arm=32))
    assert T.launch_counts()["i8_top2g"] == 5 * 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.scores, w.scores)
    assert len(pipe.stage_seconds["prepare"]) == 5


def test_kernel_s_wraps_like_int32(cuda):
    """All-127 operands: every lane sum passes 2**31 and wraps mod 2**32."""
    corpus = torch.full((3 * T._TURBO_UNIT, 384), 127, dtype=torch.int8, device=cuda)
    q8 = torch.full((32, 384), 127, dtype=torch.int8, device=cuda)
    got = T.dot_only_cells(q8, corpus)
    want = T.dot_only_plain(q8, corpus)
    assert torch.equal(got, want)
    exact = 127 * 127 * 384 * 3 * 128  # per lane, beyond int32
    assert (got.long() == (exact + 2**31) % 2**32 - 2**31).all()


def test_measurement_tools_run_on_the_card(cuda):
    """Each tool's core at a small size, on the card: rows with times, and
    kernels S, C1, C2 and A launched as the probes say."""
    from openintel_tpu_torch.tools import common, grouped_ab, kernel_decomp, topk_reduce_ab

    emb, q = common.script_corpus(40_000, 64, near_docs=True, dim=64)
    rows, corpus, q8s, qfs = common.device_operands(emb, q, 2, 32, cuda)
    ref_ids = common.exact_ids(rows, qfs.view(64, 64)[:32])
    T.reset_launch_counts()
    decomp = kernel_decomp.decompose(corpus, q8s, 40_000, reps=1)
    reduce = topk_reduce_ab.reduce_ab(corpus, rows, q8s, qfs, 40_000, ref_ids, reps=1)
    grouped = grouped_ab.grouped_ab(corpus, rows, q8s, qfs, 40_000, ref_ids, groups=[2], reps=1)
    counts = T.launch_counts()
    assert counts["dot_only"] == counts["turbo_i8"] == counts["i8_top2g"] == 4
    assert counts["turbo_i8_top2"] == 4 * (2 + len(reduce) + 1)
    for row in (*decomp, *reduce, *grouped):
        if not row.get("derived"):  # the fold row: a difference of two rows
            assert 0 < row["ms_best"] <= row["ms_median"]
    assert all(0.9 <= r["recall"] <= 1.0 for r in (*reduce, *grouped))


@pytest.mark.parametrize("b", [45, 96, 256])  # pads to 64, 96 (a half-empty warpgroup), 256
@pytest.mark.parametrize("data", ["random", "ties"])
def test_kernel_a_new_equals_v1(cuda, data, b):
    """The TMA + wgmma kernel A against its v1 control, bit for bit, both stages
    alone too (the fold on the twin's steps); each launch counted apart."""
    n = 9 * T._TURBO_UNIT + 77  # 10 supers: groups 1, 3 (short last) and 10
    rng = np.random.default_rng(25)
    if data == "ties":
        e8 = torch.from_numpy(rng.integers(-1, 2, (n, 384)).astype(np.int8))
        q8 = torch.from_numpy(rng.integers(-1, 2, (b, 384)).astype(np.int8))
    else:
        emb = synthetic_embeddings(n, dim=384, seed=26)
        e8 = T.quantize_int8(torch.from_numpy(emb))
        q8 = T.quantize_int8(torch.from_numpy(synthetic_query_embeddings(emb, b, seed=27)[0]))
    corpus = T.pad_corpus_rows(e8.to(cuda))
    q = T._pad_query_rows(q8.to(cuda), 32).contiguous()
    for group, sub in ((1, 64), (3, 32), (10, 2)):
        T.reset_launch_counts()
        got = T.i8_top2g_cells(q, corpus, group=group, sub=sub)
        v1 = T.i8_top2g_cells_v1(q, corpus, group=group, sub=sub)
        folded = T.i8_fold_steps(
            T.i8_step_tops_plain(q, corpus, sub=sub), n_super=10, group=group, sub=sub
        )
        torch.cuda.synchronize()
        counts = {k: v for k, v in T.launch_counts().items() if v}
        assert counts == {"i8_top2g": 1, "i8_top2g_v1": 1, "i8_fold": 1}
        for g, w, f in zip(got, v1, folded):
            assert torch.equal(g, w) and torch.equal(f, w)
    kv, ki = T.dense_topk_fast_i8_grouped(corpus, q8.to(cuda), k=64, n_docs=n, group=3)
    pv, pi = T.dense_topk_fast_i8_grouped(corpus, q8.to(cuda), k=64, n_docs=n, group=3, plain=True)
    assert ki.shape == (b, 64) and torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("b", [45, 96, 256])
def test_kernel_d_new_against_v1(cuda, b):
    """bf16: the TMA + wgmma kernel D against its v1 control, bit for bit on dyadic
    operands, within a step on random rows; launches counted apart."""
    n = 4 * T._TURBO_UNIT + 9_000  # 5 supers, the last one short
    rng = np.random.default_rng(28)
    emb = synthetic_embeddings(n, dim=384, seed=29)
    for exact, rows, qs in (
        (True, dyadic_rows(rng, n, 384), dyadic_rows(rng, b, 384)),
        (False, emb, synthetic_query_embeddings(emb, b, seed=30)[0]),
    ):
        corpus = T.pad_corpus_rows(torch.from_numpy(rows).to(cuda, torch.bfloat16))
        q = T._pad_query_rows(torch.from_numpy(qs).to(cuda, torch.bfloat16), 32).contiguous()
        T.reset_launch_counts()
        got, v1 = T.fast_cells(q, corpus), T.fast_cells_v1(q, corpus)
        torch.cuda.synchronize()
        assert {k: v for k, v in T.launch_counts().items() if v} == {"turbo_f32": 1, "turbo_f32_v1": 1}
        if exact:
            assert torch.equal(got, v1)
        decode = lambda c: (c & ~127).view(torch.float32).double()  # noqa: E731
        assert (decode(got) - decode(v1)).abs().max() <= QUANTUM


@pytest.mark.parametrize("dim", [64, 384, 640, 1024, 2048])  # 640+: queries from shared memory; 2048 streamed
@pytest.mark.parametrize("b", [45, 96, 256])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_kernel_e_new_against_v1(cuda, data, b, dim):
    """Kernels E1/E2 on the TMA + wgmma stream against their v1 control and
    the twin, bit for bit, with a ragged last super; E2 also with one part
    per super and with four (merged by the second kernel); each launch
    counted apart."""
    n = 2 * T._TURBO_UNIT + 5_001  # 3 supers, the last doc pairs with padding
    rng = np.random.default_rng(31)
    if data == "ties":  # nibbles and queries in {-1, 0, 1}
        e4 = torch.from_numpy(rng.integers(-1, 2, (n, dim)).astype(np.int8))
        q8 = torch.from_numpy(rng.integers(-1, 2, (b, dim)).astype(np.int8))
    else:
        emb = synthetic_embeddings(n, dim=dim, seed=32)
        e4 = T.quantize_int4(torch.from_numpy(emb))
        q8 = T.quantize_int8(torch.from_numpy(synthetic_query_embeddings(emb, b, seed=33)[0]))
    packed = T.pack_corpus_i4(e4).to(cuda)
    q = T._pad_query_rows(q8.to(cuda), 32).contiguous()
    for slots, name in ((1, "turbo_i4"), (2, "turbo_i4_top2")):
        want = T.i4_cells_plain(q, packed, slots=slots)
        T.reset_launch_counts()
        got, v1 = T.i4_cells(q, packed, slots=slots), T.i4_cells_v1(q, packed, slots=slots)
        torch.cuda.synchronize()
        counts = {k: v for k, v in T.launch_counts().items() if v}
        assert counts == {name: 1, f"{name}_v1": 1}
        assert torch.equal(got, want) and torch.equal(v1, want)
    for max_parts in (1, 4):
        assert torch.equal(T.i4_cells(q, packed, slots=2, max_parts=max_parts), want)
    kv, ki = T.dense_topk_fast_i4(packed, q8.to(cuda), k=300, n_docs=n, slots=2)
    pv, pi = T.dense_topk_fast_i4(packed, q8.to(cuda), k=300, n_docs=n, slots=2, plain=True)
    assert ki.shape == (b, 300) and torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("dim", [100, 200])
@pytest.mark.parametrize(
    "kernel,counter",
    [("int8", "i8_top2g"), ("fast", "turbo_f32"), ("int4", "turbo_i4_top2"), ("pallas", "fused_topk")],
)
def test_hybrid_paths_at_a_misfit_width(cuda, kernel, counter, dim):
    """Every arm serves D = 100 and 200 on the card (the corpora padded at
    load to 112 and 208 columns, the queries per call), equal to its
    plain-twin path; dyadic rows make every sum exact."""
    rng = np.random.default_rng(34)
    retr = _hybrid_pair(cuda, kernel, dyadic_rows(rng, 40_000, dim))
    assert retr.dense._emb_device.shape[1] == T.padded_dim(dim)
    got, want = _run_both(retr, dyadic_rows(rng, 70, dim), counter)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)


# c_fetch 64/128, 1,024 (~51 survivors of c = 32) and 1,024 (every pool starves)
@pytest.mark.parametrize("share", [0.5, 0.05, 0.01])
@pytest.mark.parametrize(
    "kernel,counter",
    [("int8", "i8_top2g"), ("fast", "turbo_f32"), ("int4", "turbo_i4_top2"), ("pallas", "fused_topk")],
)
def test_filtered_hybrid_paths_match_twins(cuda, kernel, counter, share):
    """Filtered batches on the card, every arm: the over-fetched pool
    (kernel B at k = 1,024 under the 5 and 1 % masks) equal to its plain
    pool, then the compaction and, where the pool starves, the fallback;
    the results equal to the plain-twin path on dyadic rows (every sum
    exact), with no masked id."""
    rng = np.random.default_rng(61)
    retr = _hybrid_pair(cuda, kernel, dyadic_rows(rng, 40_000, 64))
    mask = rng.random(40_000) < share
    q = dyadic_rows(rng, 70, 64)
    prep = _assert_pools_equal(retr, q, filter_mask=mask)
    assert share == 0.5 or prep.c_fetch == 1024
    got, want = _run_both(retr, q, counter, filter_mask=mask)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert mask[got.ids[got.ids >= 0]].all()


def test_filtered_int8_path_at_group_5(cuda):
    """67 supers (the last one short) at D = 16 under a 1 % mask: c_fetch
    1,024 makes kernel A fold groups of 5 (14 groups, the last of 2 supers,
    as 77 supers at 1.25M docs), 4,096 key columns; the pools equal the
    plain pools, and the path its plain-twin path, grouped masks too."""
    n = 66 * T._TURBO_UNIT + 5_000
    rng = np.random.default_rng(62)
    retr = _hybrid_pair(cuda, "int8", dyadic_rows(rng, n, 16))
    assert T.auto_i8_group(n, 1024) == 5
    q = dyadic_rows(rng, 70, 16)
    mask = rng.random(n) < 0.01
    _assert_pools_equal(retr, q, filter_mask=mask)
    got, want = _run_both(retr, q, "i8_top2g", filter_mask=mask)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert mask[got.ids[got.ids >= 0]].all()
    masks = np.stack([np.ones(n, bool), mask])
    groups = np.arange(70, dtype=np.int32) % 2
    got, want = _run_both(retr, q, "i8_top2g", filter_mask=masks, filter_group=groups)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)


def test_filtered_pipelined_serving_on_the_card_matches_sequential(cuda):
    """Filtered and grouped waves between unfiltered ones in the port's
    PipelinedSearcher on the card: the masks staged on the producer's
    stream, the survivor counts back through the pinned copy, the fallback
    on the consumer's stream; every wave bit-identical to prepare ->
    run_prepared."""
    from openintel_tpu_torch.serving import PipelinedSearcher

    n, dim = 3 * T._TURBO_UNIT, 128
    rng = np.random.default_rng(63)
    index = synthetic_postings_index(n, vocab_size=2_000, seed=64)
    emb = synthetic_embeddings(n, dim=dim, seed=65)
    retr = HybridRetriever(
        index, DenseIndex.from_embeddings(emb, dtype=torch.bfloat16), kernel="int8",
        device=cuda, device_batch=64,
    )
    masks = np.stack([rng.random(n) < 0.5, rng.random(n) < 0.01, np.zeros(n, bool)])
    masks[2, rng.choice(n, 20, replace=False)] = True
    groups = np.arange(128, dtype=np.int32) % 3
    filters = [{}, {"filter_mask": masks[0]}, {"filter_mask": masks, "filter_group": groups},
               {"filter_mask": masks[2]}, {}]
    waves = []
    for f in filters:
        term_ids = [list(rng.integers(20, 2_000, size=3)) for _ in range(128)]
        q = synthetic_query_embeddings(emb, 128, seed=int(rng.integers(1 << 30)))[0]
        waves.append((term_ids, q, f))
    kw = {"k": 10, "candidates_per_arm": 32}
    want = [retr.run_prepared(retr.prepare(t, q, **f, **kw)) for t, q, f in waves]
    T.reset_launch_counts()
    got = list(PipelinedSearcher(retr, depth=2).run_prepared_stream(iter(waves), **kw))
    assert T.launch_counts()["i8_top2g"] == len(waves) * 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.scores, w.scores)


def _live_corpus(cuda, kernel, n, dim, rng):
    """A live corpus on the card over dyadic rows (every sum exact): the
    main segment, 300 added docs (their own dyadic rows), 1 % deleted."""
    from openintel_tpu_torch.models.updatable import UpdatableHybridRetriever

    index = synthetic_postings_index(n, vocab_size=2_000, seed=5)
    rows = torch.from_numpy(dyadic_rows(rng, n, dim)).to(torch.bfloat16)
    upd = UpdatableHybridRetriever(
        index, DenseIndex(embeddings=rows, n_docs=n, dim=dim), kernel=kernel,
        device=cuda, device_batch=32,
    )
    texts = [" ".join(f"t{t}" for t in rng.integers(20, 2_000, size=6)) for _ in range(300)]
    upd.add_documents(texts, embeddings=dyadic_rows(rng, 300, dim))
    upd.delete_ids(rng.choice(n + 300, (n + 300) // 100, replace=False))
    return upd


@pytest.mark.parametrize("kernel,counter", [("int8", "i8_top2g"), ("pallas", "fused_topk")])
def test_updatable_paths_match_plain(cuda, kernel, counter):
    """A live corpus on the card (main segment on kernel A or B, the
    delta's exact arm, tombstones through the over-fetch): every mode and
    a grouped user filter equal to the ``plain=True`` route, bit for bit,
    with the kernel launched once per sub-batch and no deleted id."""
    rng = np.random.default_rng(81)
    upd = _live_corpus(cuda, kernel, 40_000, 64, rng)
    strings = [" ".join(f"t{t}" for t in rng.integers(20, 2_000, size=3)) for _ in range(70)]
    q = dyadic_rows(rng, 70, 64)
    masks = np.stack([np.ones(upd.n_docs, bool), rng.random(upd.n_docs) < 0.3])
    groups = np.arange(70, dtype=np.int32) % 2
    for mode, filters in (
        ("hybrid", {}), ("dense", {}), ("bm25", {}),
        ("hybrid", {"filter_mask": masks, "filter_group": groups}),
    ):
        kw = {"k": 10, "candidates_per_arm": 32, "mode": mode, "query_embeddings": q, **filters}
        T.reset_launch_counts()
        got = upd.search(strings, **kw)
        launched = T.launch_counts()[counter]
        want = upd.search(strings, plain=True, **kw)
        assert launched == (0 if mode == "bm25" else 3), (mode, launched)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.scores, want.scores)
        assert upd._st.alive[got.ids[got.ids >= 0]].all()


def test_concurrent_searches_during_updates_on_the_card(cuda):
    """Three threads search a live corpus on the card (kernel A) while
    adds and deletes land: no error, every search one epoch; afterwards
    the results equal the plain route's."""
    import threading

    rng = np.random.default_rng(82)
    upd = _live_corpus(cuda, "int8", 40_000, 64, rng)
    strings = ["t20 t31", "t400", "t77 t1500 t9"]
    errors, stop = [], threading.Event()

    def searcher():
        while not stop.is_set():
            try:
                r = upd.search(strings, k=5, candidates_per_arm=10)
                assert r.ids.shape == (3, 5)
                assert upd.n_docs > int(r.ids.max())
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=searcher) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for i in range(8):
            texts = [f"fresh t{20 + i} t{31 + i} doc{j}" for j in range(8)]
            upd.add_documents(texts)
            upd.delete_ids([i, upd.n_docs - 1])
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors, errors
    got = upd.search(strings, k=10, candidates_per_arm=32)
    want = upd.search(strings, k=10, candidates_per_arm=32, plain=True)
    np.testing.assert_array_equal(got.ids, want.ids)


def test_save_dense_copies_a_card_tensor_to_the_host(cuda, tmp_path):
    from openintel_tpu_torch.index.checkpoint import load_dense, save_dense

    rows = torch.randn(300, 48, device=cuda).to(torch.bfloat16)
    save_dense(DenseIndex(embeddings=rows, n_docs=300, dim=48), tmp_path / "d.npz")
    got = load_dense(tmp_path / "d.npz").embeddings
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    assert torch.equal(got.view(torch.int16), rows.cpu().view(torch.int16))


@functools.lru_cache(maxsize=1)
def _neural_rows(n):
    """Embeddings of the encoder at the CLI's default config (D = 256,
    random weights from seed 0), encoded on the card: (docs, queries)."""
    from openintel_tpu_torch.index.synthetic import flip_tokens, synthetic_synonym_corpus
    from openintel_tpu_torch.models.encoder import NeuralEmbedder

    docs, syn = synthetic_synonym_corpus(n, n_concepts=2000, seed=0)
    rng = np.random.default_rng(1)
    queries = [" ".join(flip_tokens(d.split()[:4], syn, 0.5, rng)) for d in docs[:256]]
    emb = NeuralEmbedder(device="cuda")
    return torch.from_numpy(emb(docs)).cuda(), torch.from_numpy(emb(queries)).cuda()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_on_the_card_matches_the_cpu(cuda, dtype):
    """The encoder at the CLI's default width on the card against the
    port on the CPU, from the same weights: f32 within 1e-5 (TF32 off;
    the products sum in other orders), bf16 within 2e-2 (the card's bf16
    products round once per sum, the CPU's otherwise)."""
    from openintel_tpu_torch.index.synthetic import synthetic_synonym_corpus
    from openintel_tpu_torch.models.encoder import EncoderConfig, NeuralEmbedder, init_params

    cfg = EncoderConfig(dtype=dtype)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    texts = synthetic_synonym_corpus(2_049, n_concepts=2000, seed=0)[0]
    host = NeuralEmbedder(cfg, model, device="cpu")(texts)
    card = NeuralEmbedder(cfg, model, device=cuda)(texts)
    np.testing.assert_allclose(card, host, rtol=0, atol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("group", [1, 2, 3])
def test_kernel_a_on_neural_embeddings_at_d256(cuda, group):
    """Kernel A's cells over the encoder's rows (D = 256) bit-identical to
    its twin: 2 supers and a short one."""
    rows, queries = _neural_rows(2 * T._TURBO_UNIT + 77)
    corpus = convert.int8_corpus(rows)
    q8 = T.quantize_int8(queries)
    before = T.launch_counts()["i8_top2g"]
    got = T.i8_top2g_cells(q8, corpus, group=group, sub=64)
    want = T.i8_top2g_cells_plain(q8, corpus, group=group, sub=64)
    torch.cuda.synchronize()
    assert T.launch_counts()["i8_top2g"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_b_on_neural_embeddings_at_d256(cuda, dtype):
    """Kernel B over the encoder's rows (D = 256) at k = 20 against its
    twin by its rule (scores within 2e-6, ids only at near-ties)."""
    rows, queries = _neural_rows(2 * T._TURBO_UNIT + 77)
    d, q = rows.to(dtype), queries.to(dtype)
    before = T.launch_counts()["fused_topk"]
    got = T.fused_topk(d, q, 20)
    torch.cuda.synchronize()
    assert T.launch_counts()["fused_topk"] == before + 1
    _assert_b_rule(got, T.fused_topk_plain(d, q, 20))


# ---------- ROADMAP item 12: the reranker, the analyzers, the batched engine ----------

RR_KW = dict(vocab_size=4096, dim=64, depth=2, heads=4, max_len=64)


def _reranker_pair(dtype="float32"):
    from openintel_tpu_torch.models.encoder import EncoderConfig
    from openintel_tpu_torch.models.reranker import CrossEncoderReranker

    cfg = EncoderConfig(**RR_KW, dtype=dtype)
    return (
        CrossEncoderReranker(cfg, seed=1, device="cuda"),
        CrossEncoderReranker(cfg, seed=1, device="cpu"),
    )


def _same_rerank(got, want, tol):
    """The reranked ids equal but where two candidates' scores differ by
    less than ``tol``; the scores within ``tol``."""
    np.testing.assert_allclose(np.sort(got.scores, axis=1), np.sort(want.scores, axis=1), rtol=0, atol=tol)
    differ = got.ids != want.ids
    assert (np.abs(got.scores - want.scores)[differ] < 2 * tol).all()
    for g, w in zip(got.ids, want.ids):
        assert sorted(g.tolist()) == sorted(w.tolist())


@pytest.mark.parametrize("kernel,counter", [("int8", "i8_top2g"), ("pallas", "fused_topk")])
def test_reranked_search_runs_its_first_stage_on_a_kernel(cuda, kernel, counter):
    """``RerankedRetriever`` on the card: the first stage through kernel A
    or B (one launch per sub-batch), its top-2k reranked on the card as
    the CPU reranks the same first-stage result."""
    from openintel_tpu_torch.index.synthetic import synthetic_queries_from_docs, synthetic_token_corpus
    from openintel_tpu_torch.models.reranker import RerankedRetriever, rerank_search_result

    docs = synthetic_token_corpus(3_000, vocab_size=500, seed=3)
    queries = synthetic_queries_from_docs(docs, 64, seed=4)
    retr = HybridRetriever.build(docs, dim=64, kernel=kernel, device=cuda)
    rr_card, rr_cpu = _reranker_pair()
    before = T.launch_counts()[counter]
    got = RerankedRetriever(rr_card, retr, docs).search(queries, k=10)
    assert T.launch_counts()[counter] == before + 1
    first = retr.search(queries, k=20, candidates_per_arm=40)
    want = rerank_search_result(rr_cpu, queries, first, docs)
    _same_rerank(got, type(got)(ids=want.ids[:, :10], scores=want.scores[:, :10]), 1e-5)
    for g, f in zip(got.ids, first.ids):
        assert set(g.tolist()) <= set(f.tolist())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_reranker_scores_on_the_card_match_the_cpu(cuda, dtype, tol):
    from openintel_tpu_torch.index.synthetic import synthetic_token_corpus

    docs = synthetic_token_corpus(512, vocab_size=500, seed=5)
    rr_card, rr_cpu = _reranker_pair(dtype)
    ids, mask = rr_cpu.encode_pairs([d[:20] for d in docs[:64]], [docs[i : i + 8] for i in range(64)])
    np.testing.assert_allclose(rr_card.score_pairs(ids, mask), rr_cpu.score_pairs(ids, mask), rtol=0, atol=tol)


def test_neural_analyzer_on_the_card_matches_the_cpu(cuda):
    from openintel_tpu_torch.index.synthetic import synthetic_token_corpus
    from openintel_tpu_torch.models.encoder import EncoderConfig, init_analyzer_head, init_params
    from openintel_tpu_torch.models.neural_analyzer import NeuralAnalyzer

    cfg = EncoderConfig(**RR_KW)
    model = init_params(torch.Generator().manual_seed(2), cfg)
    head = init_analyzer_head(torch.Generator().manual_seed(3), cfg)
    texts = synthetic_token_corpus(3_000, vocab_size=500, seed=6)
    host = NeuralAnalyzer(cfg, model, head, device="cpu").logits(texts)
    card = NeuralAnalyzer(cfg, init_params(torch.Generator().manual_seed(2), cfg), head, device=cuda).logits(texts)
    np.testing.assert_allclose(card, host, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [512, 2_000, 100_000])
def test_lexicon_device_path_is_bit_equal_to_the_twin(cuda, n):
    from openintel_tpu_torch.models import lexicon as L
    from openintel_tpu_torch.ops.tokenizer import encode_padded, tokenize_batch

    words = list(L.BULL_TERMS + L.BEAR_TERMS + L.JARGON_TERMS) + ["the", "stock", "report"]
    rng = np.random.default_rng(n)
    texts = [" ".join(rng.choice(words, size=int(rng.integers(0, 16))).tolist()) for _ in range(n)]
    ids, mask = encode_padded(tokenize_batch(texts), L._LEX_VOCAB)
    pol, spec = L.score_token_ids(ids, mask, L._LEX_FLAGS, device=cuda)
    assert pol.is_cuda
    want_p, want_s = L.score_token_ids_np(ids, mask, L._LEX_FLAGS)
    np.testing.assert_array_equal(pol.cpu().numpy().view(np.uint32), want_p.astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(spec.cpu().numpy(), want_s)


def _engine_inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, n + 1, size=b)
    valid = np.arange(n)[None, :] < counts[:, None]
    pol = rng.uniform(-1.3, 1.3, size=(b, n)).astype(np.float32)
    pol[rng.random((b, n)) < 0.05] = np.nan
    return dict(
        polarity=pol, speculative=rng.random((b, n)) < 0.3, valid=valid,
        present=rng.random(b) < 0.8, last_price=rng.uniform(50, 250, b).astype(np.float32),
        previous_close=rng.choice([0.0, 100.0, 185.0], b).astype(np.float32),
        volume=rng.uniform(0, 1e8, b).astype(np.float32),
        avg_volume=rng.choice([0.0, 0.5, 5.2e7], b).astype(np.float32),
        iv_rank=rng.uniform(0, 1, b).astype(np.float32), iv_present=rng.random(b) < 0.5,
    )


@pytest.mark.parametrize("b,n", [(64, 2_000), (1_024, 1_024)])
def test_aggregate_batch_on_the_card_matches_the_cpu(cuda, b, n):
    import dataclasses

    from openintel_tpu_torch.domain.engine import EngineConfig
    from openintel_tpu_torch.domain.engine_batch import BatchMarket, BatchSignals, aggregate_batch

    arrays = _engine_inputs(b, n, seed=b)

    def run(device):
        def split(cls):
            return cls(**{f.name: torch.from_numpy(arrays[f.name]).to(device) for f in dataclasses.fields(cls)})

        return aggregate_batch(split(BatchSignals), split(BatchMarket), EngineConfig())

    card, host = run(cuda), run("cpu")
    assert card.crowding.is_cuda
    for name in ("total_mentions", "bullish", "bearish", "neutral", "alignment", "confidence"):
        assert torch.equal(getattr(card, name).cpu(), getattr(host, name)), name
    for name in ("net_sentiment", "speculation_index", "pct_change", "rvol", "crowding"):
        np.testing.assert_allclose(
            getattr(card, name).cpu().numpy(), getattr(host, name).numpy(), rtol=1e-6, atol=1e-6, err_msg=name
        )


def test_atr_batch_on_the_card_matches_the_cpu_and_the_scalar_atr(cuda):
    from openintel_tpu_torch.domain.risk import atr, atr_batch
    from openintel_tpu_torch.domain.values import Bar

    rng = np.random.default_rng(9)
    high = rng.uniform(100, 110, size=(512, 250)).astype(np.float32)
    low = (high - rng.uniform(0, 5, size=high.shape)).astype(np.float32)
    close = ((high + low) / 2).astype(np.float32)
    host = atr_batch(*map(torch.from_numpy, (high, low, close)))
    card = atr_batch(*(torch.from_numpy(a).to(cuda) for a in (high, low, close)))
    np.testing.assert_allclose(card.cpu().numpy(), host.numpy(), rtol=1e-6, atol=0)
    for i in (0, 77, 511):
        bars = [Bar(float(h), float(l), float(c)) for h, l, c in zip(high[i], low[i], close[i])]
        np.testing.assert_allclose(float(card[i]), atr(bars, 14), rtol=1e-5)


@pytest.mark.parametrize("b", [512, 1024])  # tools/batch_ab's sub-batches
@pytest.mark.parametrize("data", ["random", "ties"])
def test_kernel_c2_at_the_batch_tools_widths(cuda, data, b):
    """Kernel C2 at sub-batches of 512 and 1,024 over 2 supers (the last
    short): its cells and ``dense_topk_fast_i8`` bit for bit against the
    plain twin, one launch a call."""
    n = T._TURBO_UNIT + 5_000
    rng = np.random.default_rng(41)
    if data == "ties":  # entries in {-1, 0, 1}
        e8 = torch.from_numpy(rng.integers(-1, 2, (n, 384)).astype(np.int8))
        q8 = torch.from_numpy(rng.integers(-1, 2, (b, 384)).astype(np.int8))
    else:
        emb = synthetic_embeddings(n, dim=384, seed=42)
        e8 = T.quantize_int8(torch.from_numpy(emb))
        q8 = T.quantize_int8(torch.from_numpy(synthetic_query_embeddings(emb, b, seed=43)[0]))
    corpus = T.pad_corpus_rows(e8.to(cuda))
    q8 = q8.to(cuda)
    before = T.launch_counts()["turbo_i8_top2"]
    got = T.i8_turbo_cells(q8, corpus, slots=2)
    torch.cuda.synchronize()
    assert T.launch_counts()["turbo_i8_top2"] == before + 1
    assert torch.equal(got, T.i8_turbo_cells_plain(q8, corpus, slots=2))
    for k in (32, 300):
        kv, ki = T.dense_topk_fast_i8(corpus, q8, k=k, n_docs=n)
        pv, pi = T.dense_topk_fast_i8(corpus, q8, k=k, n_docs=n, plain=True)
        assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("b", [256, 1024])
@pytest.mark.parametrize("scale", [32.0, 40.0])  # the served scale; tools/int4_ab's second
def test_kernel_e2_on_the_int4_tools_corpora(cuda, scale, b):
    """``dense_topk_fast_i4`` (kernel E2) on the int4 corpus quantised at
    scales 32 and 40, at k = 128 and 256 (the fetches of 160 and 288) and
    B = 256 and 1,024: cells and decode bit for bit against the plain
    twin."""
    n = 2 * T._TURBO_UNIT + 5_001  # ragged: the last doc pairs with padding
    emb = synthetic_embeddings(n, dim=384, seed=44)
    rows = torch.from_numpy(emb).to(cuda)
    packed = convert.int4_corpus(rows, scale=scale)
    q8 = T.quantize_int8(torch.from_numpy(synthetic_query_embeddings(emb, b, seed=45)[0])).to(cuda)
    before = T.launch_counts()["turbo_i4_top2"]
    got = T.i4_cells(q8, packed, slots=2)
    torch.cuda.synchronize()
    assert T.launch_counts()["turbo_i4_top2"] == before + 1
    assert torch.equal(got, T.i4_cells_plain(q8, packed, slots=2))
    for k in (128, 256):
        kv, ki = T.dense_topk_fast_i4(packed, q8, k=k, n_docs=n, scale=scale)
        pv, pi = T.dense_topk_fast_i4(packed, q8, k=k, n_docs=n, scale=scale, plain=True)
        assert torch.equal(ki, pi) and torch.equal(kv, pv)
        assert int(ki.max()) < n
