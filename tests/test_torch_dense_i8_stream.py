"""Kernels C1/C2 as the Hopper kernel (``csrc/turbo_i8_tma.cu``) runs them:
a super split into parts that meet where the parts end, and the consumer
loop's measurement variants (three accumulator sets, pair folds).

Tolerance: bit-identical throughout (integer keys). The parts' twin
(``i8_turbo_part_cells_plain``) merged by ``merge_part_cells_plain`` (the
twin of ``merge_top2``, which kernels E2 and C2 share) over 1, 2 and 4
parts equals ``i8_turbo_cells_plain`` cell for cell, and through
``dense_topk_fast_i8`` equals the JAX kernels in interpret mode, on random
and tie-heavy operands. A Python model of ``consume``'s three-set loop
checks that every sub-block is folded once, in order, before its set is
reused, and a numpy model of the pair fold gives the top-2 of four keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openintel_tpu.index.synthetic import synthetic_embeddings, synthetic_query_embeddings
from openintel_tpu.ops.pallas import dense_topk as J
from openintel_tpu_torch.ops import dense_topk as T

N = 2 * 16_384 + 7_001  # 3 supers, the last one short
B = 45  # pads to 64
DIM = 64


@pytest.fixture(scope="module")
def i8_operands():
    emb = synthetic_embeddings(N, dim=DIM, seed=91)
    q, _ = synthetic_query_embeddings(emb, B, seed=92)
    rng = np.random.default_rng(93)  # entries in {-1, 0, 1}: equal dots abound
    return {
        "random": (J.quantize_int8(emb), J.quantize_int8(q)),
        "ties": (
            rng.integers(-1, 2, size=(N, DIM)).astype(np.int8),
            rng.integers(-1, 2, size=(B, DIM)).astype(np.int8),
        ),
    }


def _padded(e8, q8):
    corpus = T.pad_corpus_rows(torch.from_numpy(e8))
    q = torch.cat([torch.from_numpy(q8), torch.zeros((64 - B, DIM), dtype=torch.int8)])
    return q, corpus


def parts_plain(parts):
    def cells(queries, corpus, *, slots):
        split = T.i8_turbo_part_cells_plain(queries, corpus, slots=slots, parts=parts)
        return T.merge_part_cells_plain(split, slots=slots)

    return cells


# ---- parts of a super, and where they meet ---------------------------------


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_parts_merged_equal_the_cells_twin(i8_operands, data, slots, parts):
    q, corpus = _padded(*i8_operands[data])
    want = T.i8_turbo_cells_plain(q, corpus, slots=slots)
    split = T.i8_turbo_part_cells_plain(q, corpus, slots=slots, parts=parts)
    assert split.shape == (parts, *want.shape)
    assert torch.equal(T.merge_part_cells_plain(split, slots=slots), want)
    # the buffers merge alike in any order (distinct keys)
    assert torch.equal(T.merge_part_cells_plain(split.flip(0), slots=slots), want)


def test_part_buffers_hold_their_own_sub_blocks(i8_operands):
    """Buffer p of 4 holds the top-2 over pos 32 p .. 32 p + 31 only."""
    q, corpus = _padded(*i8_operands["random"])
    split = T.i8_turbo_part_cells_plain(q, corpus, slots=2, parts=4)
    half = 3 * 128
    pos = split & 127
    for p in range(4):
        assert ((pos[p] >= 32 * p) & (pos[p] < 32 * (p + 1))).all()
    assert (split[:, :, half:] < split[:, :, :half]).all()


@pytest.mark.parametrize("parts", [0, 3, 128])
def test_part_twin_refuses_uneven_or_too_short_parts(parts):
    q = torch.zeros((32, DIM), dtype=torch.int8)
    corpus = torch.zeros((T._TURBO_UNIT, DIM), dtype=torch.int8)
    with pytest.raises(ValueError, match="parts"):
        T.i8_turbo_part_cells_plain(q, corpus, slots=2, parts=parts)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_parts_match_the_jax_kernel(i8_operands, monkeypatch, data, slots, parts):
    """Through ``dense_topk_fast_i8`` at the widest k whose fetch still
    leaves columns out (so the order is the exact one), against the Pallas
    kernels in interpret mode."""
    e8, q8 = i8_operands[data]
    lanes = 128 * slots
    k = 3 * lanes - lanes - 1
    jv, ji = J.dense_topk_fast_i8(
        J.pad_corpus_t_i8(jnp.asarray(e8.T)), jnp.asarray(q8), k=k,
        block_c=4096, n_docs=N, slots=slots, interpret=True,
    )
    monkeypatch.setattr(T, "i8_turbo_cells_plain", parts_plain(parts))
    tv, ti = T.dense_topk_fast_i8(
        T.pad_corpus_rows(torch.from_numpy(e8)), torch.from_numpy(q8), k=k,
        block_c=4096, n_docs=N, slots=slots, plain=True,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), np.asarray(jv).view(np.uint32))


@pytest.mark.parametrize("slots", [1, 2])
def test_v1_control_on_cpu_runs_the_twin(i8_operands, slots):
    q, corpus = _padded(*i8_operands["ties"])
    T.reset_launch_counts()
    got = T.i8_turbo_cells_v1(q, corpus, slots=slots)
    assert torch.equal(got, T.i8_turbo_cells_plain(q, corpus, slots=slots))
    assert not any(T.launch_counts().values())


# ---- the consumer loop's measurement variants ------------------------------


def three_set_schedule(per_part: int, flight: int, pairs: bool):
    """``consume``'s loop over one unit with three accumulator sets
    (``csrc/tma_stream.cuh``), one stage per sub-block: the events in
    program order, ("issue", pos, set), ("fold", pos, set) and ("done",
    pos) when a wait leaves at most ``flight`` groups running."""
    events, sets, issued = [], {}, []

    def wait(n):
        while len(issued) > n:
            events.append(("done", issued.pop(0)))

    def run3(k, pos):
        sets[pos] = k
        events.append(("issue", pos, k))
        issued.append(pos)
        wait(flight)
        if pos < 2:
            return
        if pairs:
            if pos % 2 == 0:
                events.extend([("fold", pos - 2, sets[pos - 2]), ("fold", pos - 1, sets[pos - 1])])
        else:
            events.append(("fold", pos - 2, sets[pos - 2]))

    for pos in range(0, per_part, 3):
        run3(0, pos)
        if pos + 1 < per_part:
            run3(1, pos + 1)
        if pos + 2 < per_part:
            run3(2, pos + 2)
    wait(0)
    last = (per_part - 1) % 3
    m2, m1 = {0: (2, 0), 1: (0, 1), 2: (1, 2)}[last]
    assert sets[per_part - 2] == m2 and sets[per_part - 1] == m1
    events += [("fold", per_part - 2, m2), ("fold", per_part - 1, m1)]
    return events


@pytest.mark.parametrize("per_part", [8, 16, 32, 64, 128])  # 128 / parts, parts 1 .. 16
@pytest.mark.parametrize("flight,pairs", [(2, False), (1, True)])
def test_three_set_loop_folds_each_sub_block_once_in_order(per_part, flight, pairs):
    events = three_set_schedule(per_part, flight, pairs)
    folds = [e for e in events if e[0] == "fold"]
    assert [pos for _, pos, _ in folds] == list(range(per_part))
    done, holder = set(), {}
    for e in events:
        if e[0] == "issue":  # a set is overwritten only once its sub-block is folded
            _, pos, k = e
            assert holder.get(k) is None, f"set {k} reused before sub-block {holder[k]} folded"
            holder[k] = pos
        elif e[0] == "done":
            done.add(e[1])
        else:  # a fold reads a finished set that holds its sub-block
            _, pos, k = e
            assert pos in done and holder[k] == pos
            holder[k] = None
    running = max(
        sum(1 for x in events[: i + 1] if x[0] == "issue") - sum(
            1 for x in events[: i + 1] if x[0] == "done")
        for i in range(len(events)) if events[i][0] == "fold"
    )
    assert running == flight  # the groups left on the tensor cores during a fold


@pytest.mark.parametrize("seed", range(4))
def test_pair_fold_is_the_top2_of_four_keys(seed):
    """The pair fold of ``turbo_i8_tma.cu``: a1' = max3(a1, x, y), a2' =
    max3(a2, min(x, y), min(a1, max(x, y))) over int32 keys, distinct, a1 >
    a2, equals the top-2 of {a1, a2, x, y}, also with INT_MIN starts."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(np.arange(-(2**31), 2**31 - 1, 7919, dtype=np.int64), (5000, 4), replace=False)
    keys = keys.astype(np.int32)
    if seed == 0:
        keys[:, :2] = np.iinfo(np.int32).min  # a fresh cell: a1 = a2 = INT_MIN
    a1, a2 = np.maximum(keys[:, 0], keys[:, 1]), np.minimum(keys[:, 0], keys[:, 1])
    x, y = keys[:, 2], keys[:, 3]
    got1 = np.maximum(np.maximum(a1, x), y)
    got2 = np.maximum(np.maximum(a2, np.minimum(x, y)), np.minimum(a1, np.maximum(x, y)))
    top = -np.sort(-keys.astype(np.int64), axis=1)
    np.testing.assert_array_equal(got1, top[:, 0])
    np.testing.assert_array_equal(got2, top[:, 1])


@pytest.mark.parametrize("dim", [384, 505])
def test_keys_up_to_d505_order_as_floats(dim):
    """The split-pipes measurement variant folds slot 2 on the float pipe:
    up to D=505 every key of int8 operands (|dot| <= 128**2 D) is a positive
    normal float32, so float order is int order; INT_MIN, the fold's start,
    reads as -0.0, below every key."""
    flag = (32_768 + (1 << 23)) * 128
    dots = np.array([-(128**2) * dim, -1, 0, 1, 127**2 * dim, 128**2 * dim], np.int64)
    keys = np.concatenate([d * 128 + flag + np.array([0, 127]) for d in dots]).astype(np.int64)
    assert keys.min() >= 2**23 and keys.max() < 0x7F800000  # normal, finite, positive
    as_float = keys.astype(np.int32).view(np.float32)
    order = np.argsort(keys, kind="stable")
    assert (np.diff(as_float[order]) > 0).all()
    start = np.array([np.iinfo(np.int32).min], np.int32).view(np.float32)[0]
    assert start == 0.0 and np.signbit(start) and (as_float > start).all()
