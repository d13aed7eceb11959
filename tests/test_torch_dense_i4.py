"""Port parity for kernels E1/E2 (``kernel="int4"``): ``quantize_int4``,
``pack_corpus_i4``, ``convert.int4_corpus`` and the port's
``dense_topk_fast_i4`` (its plain twin on CPU tensors) against the JAX
package, the Pallas kernels in interpret mode.

Inputs are made from seeds with numpy. The int4 cells are integer-exact,
so every comparison is bit for bit, except where the reference selects
every candidate column (k + its over-fetch reaches the capacity of
128 * slots per super): there the CPU ``approx_max_k`` sorts with no tie
rule, so the vals are bit-identical and the ids agree as sets within each
run of equal keys.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_dense_utils import assert_equal_up_to_equal_keys, i4_pos

from openintel_tpu.index.schema import DenseIndex
from openintel_tpu.index.synthetic import synthetic_embeddings, synthetic_query_embeddings
from openintel_tpu.ops.pallas import dense_topk as J
from openintel_tpu_torch import convert
from openintel_tpu_torch.ops import dense_topk as T

N = 2 * 16_384 + 7_000  # 3 supers, the last one short
B = 45  # pads to 64
DIM = 64


def test_quantize_int4_bit_identical():
    x = synthetic_embeddings(3_000, dim=DIM, seed=71)
    x[0, :6] = [0.5 / 32, -0.5 / 32, 1.5 / 32, 0.25, -0.3, 1.0]  # halves, clips
    for rows in (x, x.astype(ml_dtypes.bfloat16)):
        got = T.quantize_int4(convert.stored_rows(
            DenseIndex(embeddings=rows, n_docs=rows.shape[0], dim=DIM), "cpu"
        ))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), J.quantize_int4(rows))
    np.testing.assert_array_equal(
        T.quantize_int4(torch.from_numpy(x), scale=8.0).numpy(),
        J.quantize_int4(x, scale=8.0),
    )


@pytest.mark.parametrize("n", [1, 300, 16_384, 20_001])
def test_pack_corpus_i4_is_the_transposed_reference_packing(n):
    rng = np.random.default_rng(72)
    x4 = rng.integers(-8, 8, size=(n, 32)).astype(np.int8)
    want = J.pack_corpus_t_i4(x4.T)  # (D, N_pad / 2), padding included
    got = T.pack_corpus_i4(torch.from_numpy(x4))
    assert got.dtype == torch.int8 and got.shape == (want.shape[1], 32)
    np.testing.assert_array_equal(got.numpy(), want.T)


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_int4_corpus_matches_the_reference_operand(store):
    """Quantised from the stored rows in chunks (an odd row count, so the
    last doc pairs with padding), as DenseRetriever(kernel="int4") packs."""
    emb = synthetic_embeddings(20_001, dim=32, seed=73)
    dtype = ml_dtypes.bfloat16 if store == "bf16" else np.float32
    index = DenseIndex.from_embeddings(emb, dtype=dtype)
    want = J.pack_corpus_t_i4(J.quantize_int4(np.asarray(index.embeddings)).T)
    got = convert.int4_corpus(convert.stored_rows(index, "cpu"), chunk=7_001)
    assert got.shape == (16_384, 32)
    np.testing.assert_array_equal(got.numpy(), want.T)


@pytest.fixture(scope="module")
def i4_operands():
    emb = synthetic_embeddings(N, dim=DIM, seed=74)
    q, _ = synthetic_query_embeddings(emb, B, seed=75)
    rng = np.random.default_rng(76)  # entries in {-1, 0, 1}: equal keys abound
    return {
        "random": (J.quantize_int4(emb), J.quantize_int8(q)),
        "ties": (
            rng.integers(-1, 2, size=(N, DIM)).astype(np.int8),
            rng.integers(-1, 2, size=(B, DIM)).astype(np.int8),
        ),
    }


def _i4_both(e4, q8, k, slots, block_c=4096):
    jv, ji = J.dense_topk_fast_i4(
        jnp.asarray(J.pack_corpus_t_i4(e4.T)), jnp.asarray(q8), k=k,
        block_c=block_c, n_docs=N, slots=slots, interpret=True,
    )
    tv, ti = T.dense_topk_fast_i4(
        T.pack_corpus_i4(torch.from_numpy(e4)), torch.from_numpy(q8), k=k,
        block_c=block_c, n_docs=N, slots=slots,
    )
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("k", ["40", "widest", "1000"])
@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_kernel_e_twins_match_the_reference(i4_operands, data, slots, k):
    """``widest`` is the largest k whose fetch still leaves columns out
    (capacity - over-fetch - 1): it covers almost every cell in order.
    k=1000 clamps to the capacity (384 or 768) and pads with (0.0, -1)."""
    e4, q8 = i4_operands[data]
    lanes = 128 * slots
    cap = 3 * lanes
    k = {"40": 40, "widest": cap - lanes - 1, "1000": 1000}[k]
    (jv, ji), (tv, ti) = _i4_both(e4, q8, k, slots)
    assert ti.shape == (B, k) and ti.dtype == np.int32
    if k + lanes < cap:  # N is padded and small: the over-fetch is `lanes`
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv.view(np.uint32), jv.view(np.uint32))
    else:
        assert_equal_up_to_equal_keys(tv, ti, jv, ji, i4_pos)
        assert (ti[:, cap:] == -1).all() and (tv[:, cap:] == 0).all()
    assert ti.max() < N


def test_kernel_e2_slot_one_is_kernel_e1():
    """E2's first slot half equals E1's cells; its second slot holds each
    cell's runner-up key (below slot one, flag-biased)."""
    rng = np.random.default_rng(77)
    e4 = torch.from_numpy(rng.integers(-8, 8, size=(N, DIM)).astype(np.int8))
    q8 = torch.from_numpy(rng.integers(-127, 128, size=(32, DIM)).astype(np.int8))
    packed = T.pack_corpus_i4(e4)
    one = T.i4_cells_plain(q8, packed, slots=1)
    two = T.i4_cells_plain(q8, packed, slots=2)
    half = 3 * 128
    assert one.shape == (32, half) and two.shape == (32, 2 * half)
    assert torch.equal(two[:, :half], one)
    assert (two[:, half:] < one).all() and (two[:, half:] > 0).all()


@pytest.mark.parametrize("block_c", [128, 4096, 8192, 100, 16_384])
def test_block_c_and_layout_refused_as_in_the_reference(block_c):
    rng = np.random.default_rng(78)
    e4 = rng.integers(-8, 8, size=(300, DIM)).astype(np.int8)
    q8 = rng.integers(-127, 128, size=(3, DIM)).astype(np.int8)
    try:
        J.dense_topk_fast_i4(
            jnp.asarray(J.pack_corpus_t_i4(e4.T)), jnp.asarray(q8), k=4,
            block_c=block_c, n_docs=300, interpret=True,
        )
        ok = True
    except AssertionError:
        ok = False
    assert ok == (block_c in (128, 4096, 8192))
    packed = T.pack_corpus_i4(torch.from_numpy(e4))
    if ok:
        T.dense_topk_fast_i4(packed, torch.from_numpy(q8), k=4, block_c=block_c, n_docs=300)
    else:
        with pytest.raises(ValueError, match="block_c"):
            T.dense_topk_fast_i4(packed, torch.from_numpy(q8), k=4, block_c=block_c)
    with pytest.raises(ValueError, match="pack_corpus_i4"):  # not padded
        T.dense_topk_fast_i4(packed[:100], torch.from_numpy(q8), k=4)
    with pytest.raises(ValueError, match="slots"):
        T.dense_topk_fast_i4(packed, torch.from_numpy(q8), k=4, slots=3)
