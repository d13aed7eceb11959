"""Port parity for kernels C1/C2 and S: the port's ``dense_topk_fast_i8``
(its plain twins on CPU tensors) against the JAX package's, the Pallas
kernels in interpret mode, and the cells and lane sums against numpy
oracles.

Inputs are made from seeds with numpy. The int8 cells are integer-exact, so
every comparison is bit for bit, except where the reference selects every
candidate column (k + its over-fetch reaches the capacity of 128 * slots
per super): there the CPU ``approx_max_k`` sorts with no tie rule, so the
vals are bit-identical and the ids agree as sets within each run of equal
keys. The branch of the over-fetch taken above 262,144 docs is too large
for an interpret run; it is checked against a numpy oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dense_utils import assert_equal_up_to_equal_keys, fast_pos

from openintel_tpu.index.synthetic import synthetic_embeddings, synthetic_query_embeddings
from openintel_tpu.ops.pallas import dense_topk as J
from openintel_tpu_torch.ops import dense_topk as T

N = 40_000  # 3 supers, the last one short
B = 45  # pads to 64
DIM = 64
UNIT = 16_384
FLAG128 = (32_768 + (1 << 23)) * 128


@pytest.fixture(scope="module")
def i8_operands():
    emb = synthetic_embeddings(N, dim=DIM, seed=81)
    q, _ = synthetic_query_embeddings(emb, B, seed=82)
    rng = np.random.default_rng(83)  # entries in {-1, 0, 1}: equal keys abound
    return {
        "random": (J.quantize_int8(emb), J.quantize_int8(q)),
        "ties": (
            rng.integers(-1, 2, size=(N, DIM)).astype(np.int8),
            rng.integers(-1, 2, size=(B, DIM)).astype(np.int8),
        ),
    }


def _i8_both(e8, q8, k, slots, block_c=4096, n_docs=None):
    n_docs = e8.shape[0] if n_docs is None else n_docs
    jv, ji = J.dense_topk_fast_i8(
        J.pad_corpus_t_i8(jnp.asarray(e8.T)), jnp.asarray(q8), k=k,
        block_c=block_c, n_docs=n_docs, slots=slots, interpret=True,
    )
    tv, ti = T.dense_topk_fast_i8(
        T.pad_corpus_rows(torch.from_numpy(e8)), torch.from_numpy(q8), k=k,
        block_c=block_c, n_docs=n_docs, slots=slots,
    )
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def _assert_same(got, want):
    (tv, ti), (jv, ji) = got, want
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv.view(np.uint32), jv.view(np.uint32))


@pytest.mark.parametrize("block_c", [256, 4096])
@pytest.mark.parametrize("k", ["40", "widest", "1000"])
@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_kernel_c_twins_match_the_reference(i8_operands, data, slots, k, block_c):
    """``widest`` is the largest k whose fetch still leaves columns out
    (capacity - over-fetch - 1). k=1000 clamps to the capacity (384 or 768)
    and pads with (0.0, -1)."""
    e8, q8 = i8_operands[data]
    lanes = 128 * slots
    cap = 3 * lanes
    k = {"40": 40, "widest": cap - lanes - 1, "1000": 1000}[k]
    want, got = _i8_both(e8, q8, k, slots, block_c)
    tv, ti = got
    assert ti.shape == (B, k) and ti.dtype == np.int32
    if k + lanes < cap:  # N is padded and small: the over-fetch is `lanes`
        _assert_same(got, want)
    else:
        assert_equal_up_to_equal_keys(tv, ti, *want, fast_pos)
        assert (ti[:, cap:] == -1).all() and (tv[:, cap:] == 0).all()
    assert ti.max() < N


@pytest.mark.parametrize("n", [300, 3 * UNIT])
@pytest.mark.parametrize("slots", [1, 2])
def test_small_and_unpadded_corpora_match_the_reference(n, slots):
    """300 x 32: one super, mostly padding; its `lanes` over-fetch selects
    every column, so the equal-keys rule applies. 3 x 16,384: no padding,
    so no padding over-fetch, only the 32-slot margin: bit for bit."""
    emb = synthetic_embeddings(n, dim=32, seed=84)
    q, _ = synthetic_query_embeddings(emb, 5, seed=85)
    e8, q8 = J.quantize_int8(emb), J.quantize_int8(q)
    for k in (8, 50):
        want, got = _i8_both(e8, q8, k, slots, block_c=256)
        if n == 300:
            assert_equal_up_to_equal_keys(*got, *want, fast_pos)
        else:
            _assert_same(got, want)
        assert got[1].max() < n


def test_padding_over_fetch_below_262144_docs_matches_the_reference():
    """Every real doc scores below 0, so the zero-padded docs of the last
    super (score 0) take its lanes' slots: the `lanes`-wide over-fetch of a
    padded corpus of at most 262,144 docs still reaches real docs."""
    e8 = np.ones((N, DIM), np.int8)
    q8 = -np.ones((3, DIM), np.int8)
    for slots in (1, 2):
        want, got = _i8_both(e8, q8, 10, slots, block_c=4096)
        _assert_same(got, want)
        assert (got[1] >= 0).all()


def _oracle_cells(q8, e8_pad, slots):
    """numpy: per (query, super, lane) the top ``slots`` of dot * 128 +
    FLAG128 + pos over the super's 128 docs of that lane, int64 exact."""
    b = q8.shape[0]
    n_super = e8_pad.shape[0] // UNIT
    dots = q8.astype(np.int64) @ e8_pad.astype(np.int64).T
    keys = dots.reshape(b, n_super, 128, 128) * 128 + FLAG128
    keys += np.arange(128)[None, None, :, None]
    top = -np.sort(-keys, axis=2)[:, :, :slots]  # (b, n_super, slots, 128)
    return np.concatenate([top[:, :, j].reshape(b, -1) for j in range(slots)], axis=1)


def test_padding_over_fetch_above_262144_docs_matches_a_numpy_oracle():
    """Above 262,144 docs the reference fetches only k + 32 columns, so on
    the same all-negative operands the padding's keys fill the fetch and no
    real doc is returned (the reference's documented shadowing). The port's
    cells equal the numpy oracle's and every id is -1."""
    n = 16 * UNIT + 1  # 17 supers, one real doc in the last
    e8 = torch.ones((n, 16), dtype=torch.int8)
    q8 = -torch.ones((3, 16), dtype=torch.int8)
    padded = T.pad_corpus_rows(e8)
    q_pad = T._pad_query_rows(q8, 32)
    for slots in (1, 2):
        cells = T.i8_turbo_cells_plain(q_pad, padded, slots=slots)
        np.testing.assert_array_equal(
            cells.numpy(), _oracle_cells(q_pad.numpy(), padded.numpy(), slots)
        )
        vals, ids = T.dense_topk_fast_i8(padded, q8, k=10, n_docs=n, slots=slots)
        assert (ids == -1).all() and (vals == 0).all()
    # at most 262,144 docs, the same padding is over-fetched: real docs return
    n = 15 * UNIT + 1  # 16 supers, one real doc in the last
    padded = T.pad_corpus_rows(torch.ones((n, 16), dtype=torch.int8))
    for slots in (1, 2):
        _, ids = T.dense_topk_fast_i8(padded, q8, k=10, n_docs=n, slots=slots)
        assert (ids >= 0).all() and (ids < n).all()


def _fold(keys, order, sentinel, step):
    """The reference's streaming top-2 fold over one cell's keys in the
    given walk order: within a step of ``step`` keys a2 = max(a2, min(a1,
    key)), a1 = max(a1, key) from (key, sentinel); steps merge with
    [max(p1, a1), max(min(p1, a1), max(p2, a2))]."""
    p1 = p2 = None
    for lo in range(0, len(order), step):
        a1, a2 = keys[order[lo]], sentinel
        for i in order[lo + 1 : lo + step]:
            a2 = max(a2, min(a1, keys[i]))
            a1 = max(a1, keys[i])
        if p1 is None:
            p1, p2 = a1, a2
        else:
            p1, p2 = max(p1, a1), max(min(p1, a1), max(p2, a2))
    return p1, p2


def test_cells_depend_on_neither_walk_order_nor_block_c():
    """A cell's 128 keys are distinct (pos differs), so its top-2 is
    unique: the reference's fold at any step width (block_c / 128), in
    ascending, descending or shuffled order, from its sentinel 0 or the
    port kernels' INT_MIN, gives the twin's cells; and the reference's
    result is the same at block_c 256 and 8192."""
    rng = np.random.default_rng(86)
    e8 = rng.integers(-1, 2, size=(UNIT, 32)).astype(np.int8)  # ties in dot
    q8 = rng.integers(-1, 2, size=(32, 32)).astype(np.int8)
    twin = T.i8_turbo_cells_plain(torch.from_numpy(q8), torch.from_numpy(e8), slots=2).numpy()
    np.testing.assert_array_equal(twin, _oracle_cells(q8, e8, 2))
    dots = q8.astype(np.int64) @ e8.astype(np.int64).T
    keys = (dots.reshape(32, 128, 128) * 128 + FLAG128 + np.arange(128)[None, :, None])
    orders = [np.arange(128), np.arange(128)[::-1], rng.permutation(128)]
    for b, lane in [(0, 0), (5, 77), (31, 127)]:
        cell = keys[b, :, lane].tolist()
        for order in orders:
            for step, sentinel in ((1, 0), (2, 0), (64, 0), (128, -(2**31))):
                p1, p2 = _fold(cell, order.tolist(), sentinel, step)
                assert (p1, p2) == (twin[b, lane], twin[b, 128 + lane])
    e_t = jnp.asarray(e8.T)
    outs = [
        J.dense_topk_fast_i8(e_t, jnp.asarray(q8), k=64, block_c=bc, slots=2, interpret=True)
        for bc in (256, 8192)
    ]
    np.testing.assert_array_equal(np.asarray(outs[0][1]), np.asarray(outs[1][1]))
    np.testing.assert_array_equal(np.asarray(outs[0][0]), np.asarray(outs[1][0]))


def test_turbo_lane_collision_mechanism_and_top2_fix():
    """The port's copy of the reference's lane-collision test
    (tests/test_retriever_kernels.py): docs 10 and 138 share lane 10 of
    super 0; with slots=1 the lane keeps only its int8 max (doc 138) and
    doc 10, a true top-3 doc, is eclipsed; slots=2 recovers it."""
    rng = np.random.default_rng(5)
    n, dim = 512, 64
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((1, dim)).astype(np.float32)
    q /= np.linalg.norm(q)
    for doc, strength in ((10, 0.985), (138, 0.99), (200, 0.98)):
        v = strength * q[0] + np.sqrt(1 - strength**2) * emb[doc]
        emb[doc] = v / np.linalg.norm(v)
    corpus = T.pad_corpus_rows(T.quantize_int8(torch.from_numpy(emb)))
    q8 = T.quantize_int8(torch.from_numpy(q))
    _, ids = T.dense_topk_fast_i8(corpus, q8, k=8, n_docs=n, slots=1)
    got = {int(d) for d in ids[0] if d >= 0}
    assert 138 in got and 200 in got and 10 not in got
    _, ids2 = T.dense_topk_fast_i8(corpus, q8, k=8, n_docs=n, slots=2)
    real = [int(d) for d in ids2[0] if d >= 0]
    assert {10, 138, 200} <= set(real)
    assert len(real) == len(set(real)) and max(real) < n


def test_kernel_c2_slot_one_is_kernel_c1():
    """C2's first slot half equals C1's cells; its second holds each cell's
    runner-up key (below slot one, flag-biased)."""
    rng = np.random.default_rng(87)
    e8 = torch.from_numpy(rng.integers(-127, 128, size=(2 * UNIT, DIM)).astype(np.int8))
    q8 = torch.from_numpy(rng.integers(-127, 128, size=(32, DIM)).astype(np.int8))
    one = T.i8_turbo_cells_plain(q8, e8, slots=1)
    two = T.i8_turbo_cells_plain(q8, e8, slots=2)
    half = 2 * 128
    assert one.shape == (32, half) and two.shape == (32, 2 * half)
    assert torch.equal(two[:, :half], one)
    assert (two[:, half:] < one).all() and (two[:, half:] > 0).all()
    np.testing.assert_array_equal(two.numpy(), _oracle_cells(q8.numpy(), e8.numpy(), 2))


def _oracle_lane_sums(q8, e8_pad):
    """numpy: per (query, lane) the int64 sum of every dot, wrapped to
    int32 as the reference's int32 adds wrap."""
    dots = q8.astype(np.int64) @ e8_pad.astype(np.int64).T
    s = dots.reshape(q8.shape[0], -1, 128).sum(axis=1)
    return ((s + 2**31) % 2**32 - 2**31).astype(np.int32)


@pytest.mark.parametrize("data", ["random", "saturated"])
def test_dot_only_matches_the_wrapping_oracle(data):
    """Kernel S's twin and the ``dot_only`` op; the saturated operands (all
    127: 384 docs per lane of 127**2 * 384 each) make every lane sum wrap
    mod 2**32."""
    rng = np.random.default_rng(88)
    if data == "saturated":
        e8 = np.full((3 * UNIT, 384), 127, np.int8)
        q8 = np.full((7, 384), 127, np.int8)
    else:
        e8 = rng.integers(-127, 128, size=(2 * UNIT + 5, 64)).astype(np.int8)
        q8 = rng.integers(-127, 128, size=(7, 64)).astype(np.int8)
    padded = T.pad_corpus_rows(torch.from_numpy(e8))
    want = _oracle_lane_sums(q8, padded.numpy())
    got = T.dot_only(padded, torch.from_numpy(q8))
    assert got.shape == (7, 128) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    exact = (q8.astype(np.int64) @ padded.numpy().astype(np.int64).T).reshape(7, -1, 128).sum(1)
    assert (exact != want).any() == (data == "saturated")
    q_pad = T._pad_query_rows(torch.from_numpy(q8), 32)
    np.testing.assert_array_equal(
        T.dot_only_cells(q_pad, padded)[:7].numpy(), want
    )


@pytest.mark.parametrize("block_c", [128, 4096, 8192, 100, 16_384])
def test_block_c_and_slots_refused_as_in_the_reference(block_c):
    rng = np.random.default_rng(89)
    e8 = rng.integers(-127, 128, size=(300, DIM)).astype(np.int8)
    q8 = rng.integers(-127, 128, size=(3, DIM)).astype(np.int8)
    try:
        J.dense_topk_fast_i8(
            J.pad_corpus_t_i8(jnp.asarray(e8.T)), jnp.asarray(q8), k=4,
            block_c=block_c, n_docs=300, interpret=True,
        )
        ok = True
    except AssertionError:
        ok = False
    assert ok == (block_c in (128, 4096, 8192, 16_384))
    corpus = torch.from_numpy(e8)
    if ok:
        T.dense_topk_fast_i8(corpus, torch.from_numpy(q8), k=4, block_c=block_c, n_docs=300)
    else:
        with pytest.raises(ValueError, match="block_c"):
            T.dense_topk_fast_i8(corpus, torch.from_numpy(q8), k=4, block_c=block_c)
    with pytest.raises(ValueError, match="slots"):
        T.dense_topk_fast_i8(corpus, torch.from_numpy(q8), k=4, slots=3)
    with pytest.raises(TypeError):
        T.dense_topk_fast_i8(corpus.float(), torch.from_numpy(q8), k=4)
