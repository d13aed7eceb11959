"""Kernels E1/E2 as the Hopper kernel (``csrc/turbo_i4_tma.cu``) runs them:
packed boxes unpacked in shared memory under the 128-byte swizzle, and a
super's parts merged where they meet.

Tolerance: bit-identical throughout (integer keys). A numpy model of the
TMA swizzle shows that the flat unpack of a swizzled packed box equals the
swizzled unpacked tiles, also when a 2-block cluster lands a box as two
multicast halves; a numpy model of the kernel's ``nibbles16()`` word op
gives 16 times each signed nibble, exactly. The parts' twin
(``i4_part_cells_plain``) merged by ``merge_part_cells_plain`` over 1, 2 and
4 parts equals ``i4_cells_plain`` cell for cell, and through
``dense_topk_fast_i4`` equals the JAX kernels in interpret mode, on random
and tie-heavy operands.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openintel_tpu.index.synthetic import synthetic_embeddings, synthetic_query_embeddings
from openintel_tpu.ops.pallas import dense_topk as J
from openintel_tpu_torch.ops import dense_topk as T

N = 2 * 16_384 + 7_001  # 3 supers, the last one short and odd
B = 45  # pads to 64
DIM = 64
BOX_ROWS, BOX_BYTES = 64, 128  # a doc box: 64 rows of one 128-byte K slice


# ---- the unpack under the swizzle ------------------------------------------


def tma_store(smem: np.ndarray, box: np.ndarray, offset: int) -> None:
    """What TMA's 128-byte swizzle does with a (rows, 128) box landing at
    byte ``offset`` of shared memory: byte a goes to a ^ (((a >> 7) & 7) << 4),
    i.e. the 16-byte chunks of each 128-byte row are permuted by address
    bits 7-9 (the row within an 8-row, 1024-byte group)."""
    rows = box.shape[0]
    a = offset + np.arange(rows * BOX_BYTES)
    smem[a ^ (((a >> 7) & 7) << 4)] = box.reshape(-1)


def nibbles16(box: np.ndarray, shift: int) -> np.ndarray:
    """16 times the low (shift 0) or high (shift 4) signed nibbles of packed
    bytes, as int8: what the kernel's unpacked tiles hold."""
    v = box.astype(np.uint8).astype(np.int32)
    x = (v >> shift) & 15
    return (16 * (x - 16 * (x >> 3))).astype(np.int8)


@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flat_unpack_of_a_swizzled_box_is_the_swizzled_tiles(cluster, seed):
    """The packed box lands swizzled (in a cluster, as two 32-row halves at
    offsets 0 and 4 KB, each block loading one half into both); unpacking
    its bytes in place, offset for offset, gives exactly the low and high
    tiles as TMA would have swizzled them: the wgmma descriptor reads them
    as it reads any doc tile."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(-128, 128, size=(BOX_ROWS, BOX_BYTES)).astype(np.int8)
    smem = np.zeros(BOX_ROWS * BOX_BYTES, np.int8)
    half = BOX_ROWS // cluster
    for rank in range(cluster):
        tma_store(smem, packed[rank * half : (rank + 1) * half], rank * half * BOX_BYTES)
    whole = np.zeros_like(smem)
    tma_store(whole, packed, 0)
    np.testing.assert_array_equal(smem, whole)
    for shift in (0, 4):
        flat = nibbles16(smem, shift)  # the kernel's pass over the stage
        tile = np.zeros_like(smem)
        tma_store(tile, nibbles16(packed, shift), 0)
        np.testing.assert_array_equal(flat, tile)
        # wgmma's view of row r, byte c of a 128-byte swizzled K-major tile
        r, c = np.meshgrid(np.arange(BOX_ROWS), np.arange(BOX_BYTES), indexing="ij")
        view = flat[r * BOX_BYTES + (((c >> 4) ^ (r & 7)) << 4) + (c & 15)]
        np.testing.assert_array_equal(view, nibbles16(packed, shift))


def nibbles16_word(w: np.ndarray, shift: int) -> np.ndarray:
    """``nibbles16()`` of ``csrc/tma_stream.cuh`` on uint32 words (shift 4:
    the low nibbles, 0: the high ones)."""
    return (w << np.uint32(shift)) & np.uint32(0xF0F0F0F0)


@pytest.mark.parametrize("shift", [0, 4])
def test_nibble_word_op_is_sixteen_times_the_signed_nibble(shift):
    """Every byte value in every position of a word, beside a neighbour
    byte: each byte of the word op, read as int8, is 16 times the twin's
    signed nibble, ``((v & 15) ^ 8) - 8`` (low) or ``v >> 4`` (high), so
    the products hold 16 x each dot, exactly."""
    v = np.arange(256, dtype=np.uint32)
    for lane in range(4):
        other = np.uint32(0xA5) << np.uint32(8 * ((lane + 1) % 4))
        words = (v << np.uint32(8 * lane)) | other
        got = (nibbles16_word(words, shift) >> np.uint32(8 * lane)) & np.uint32(0xFF)
        want = torch.from_numpy(v.astype(np.uint8).view(np.int8)).to(torch.int32)
        want = ((want & 15) ^ 8) - 8 if shift == 4 else want >> 4
        np.testing.assert_array_equal(got.astype(np.uint8).view(np.int8), 16 * want.numpy())


# ---- parts of a super, and where they meet ---------------------------------


@pytest.fixture(scope="module")
def i4_operands():
    emb = synthetic_embeddings(N, dim=DIM, seed=81)
    q, _ = synthetic_query_embeddings(emb, B, seed=82)
    rng = np.random.default_rng(83)  # entries in {-1, 0, 1}: equal dots abound
    return {
        "random": (J.quantize_int4(emb), J.quantize_int8(q)),
        "ties": (
            rng.integers(-1, 2, size=(N, DIM)).astype(np.int8),
            rng.integers(-1, 2, size=(B, DIM)).astype(np.int8),
        ),
    }


def _padded(e4, q8):
    packed = T.pack_corpus_i4(torch.from_numpy(e4))
    q = torch.cat([torch.from_numpy(q8), torch.zeros((64 - B, DIM), dtype=torch.int8)])
    return q, packed


def parts_plain(parts):
    def cells(queries, corpus, *, slots):
        split = T.i4_part_cells_plain(queries, corpus, slots=slots, parts=parts)
        return T.merge_part_cells_plain(split, slots=slots)

    return cells


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_parts_merged_equal_the_cells_twin(i4_operands, data, slots, parts):
    q, packed = _padded(*i4_operands[data])
    want = T.i4_cells_plain(q, packed, slots=slots)
    split = T.i4_part_cells_plain(q, packed, slots=slots, parts=parts)
    assert split.shape == (parts, *want.shape)
    assert torch.equal(T.merge_part_cells_plain(split, slots=slots), want)
    # the buffers merge alike in any order (distinct keys)
    flipped = T.merge_part_cells_plain(split.flip(0), slots=slots)
    assert torch.equal(flipped, want)


def test_part_buffers_hold_their_own_sub_blocks(i4_operands):
    """Buffer p of 4 holds the top-2 over pos 32 p .. 32 p + 31 only."""
    q, packed = _padded(*i4_operands["random"])
    split = T.i4_part_cells_plain(q, packed, slots=2, parts=4)
    half = 3 * 128
    pos = split & 127
    for p in range(4):
        assert ((pos[p] >= 32 * p) & (pos[p] < 32 * (p + 1))).all()
    assert (split[:, :, half:] < split[:, :, :half]).all()


@pytest.mark.parametrize("parts", [0, 3, 128])
def test_part_twin_refuses_uneven_or_too_short_parts(parts):
    q = torch.zeros((32, DIM), dtype=torch.int8)
    packed = torch.zeros((T._TURBO_UNIT // 2, DIM), dtype=torch.int8)
    with pytest.raises(ValueError, match="parts"):
        T.i4_part_cells_plain(q, packed, slots=2, parts=parts)


@pytest.mark.parametrize("trial", range(4))
def test_merge_of_disjoint_top2s_is_the_top2_of_the_union(trial):
    """The combine a2 = max(min(a1, b1), max(a2, b2)) over buffers of
    disjoint distinct keys, in every order, gives the union's top-2."""
    rng = np.random.default_rng(90 + trial)
    n_parts = 2 + trial % 3
    keys = rng.choice(10_000, size=(n_parts, 6, 5), replace=False).astype(np.int32)
    tops = -np.sort(-keys, axis=2)[:, :, :2]  # (parts, cells, 2)
    cells = torch.from_numpy(np.concatenate([tops[:, :, 0], tops[:, :, 1]], axis=1))
    union = -np.sort(-keys.transpose(1, 0, 2).reshape(6, -1), axis=1)[:, :2]
    want = torch.from_numpy(np.concatenate([union[:, 0], union[:, 1]])[None])
    for order in itertools.permutations(range(n_parts)):
        got = T.merge_part_cells_plain(cells[list(order)][:, None], slots=2)
        assert torch.equal(got, want)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_parts_match_the_jax_kernel(i4_operands, monkeypatch, data, slots, parts):
    """Through ``dense_topk_fast_i4`` at the widest k whose fetch still
    leaves columns out (so the order is the exact one), against the Pallas
    kernels in interpret mode."""
    e4, q8 = i4_operands[data]
    lanes = 128 * slots
    k = 3 * lanes - lanes - 1
    jv, ji = J.dense_topk_fast_i4(
        jnp.asarray(J.pack_corpus_t_i4(e4.T)), jnp.asarray(q8), k=k,
        block_c=4096, n_docs=N, slots=slots, interpret=True,
    )
    monkeypatch.setattr(T, "i4_cells_plain", parts_plain(parts))
    tv, ti = T.dense_topk_fast_i4(
        T.pack_corpus_i4(torch.from_numpy(e4)), torch.from_numpy(q8), k=k,
        block_c=4096, n_docs=N, slots=slots, plain=True,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), np.asarray(jv).view(np.uint32))
