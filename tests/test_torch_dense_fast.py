"""Port parity for kernel D (``kernel="fast"``): the port's
``dense_topk_fast`` (its plain twin on CPU tensors) against the JAX
``dense_topk_fast`` with the Pallas kernel in interpret mode.

Inputs are made from seeds with numpy. Tolerances:
- dyadic operands (``torch_dense_utils.dyadic_rows``): every partial sum is
  exact in float32, so vals and ids are bit-identical in f32 and bf16.
  Where the reference selects every candidate column (k + its over-fetch
  reaches the capacity of 128 per super), the CPU ``approx_max_k`` sorts
  with no tie rule; there the vals are bit-identical and the ids agree as
  sets within each run of equal keys.
- random unit rows: the dots sum in another order, so a cell may move by
  one score step (2**-16 for s + 2 in [1, 2), 2**-15 in [2, 4)): vals within
  2**-15, ids equal except at ranks whose vals lie within 2**-15.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_dense_utils import (
    assert_equal_up_to_equal_keys,
    assert_quantum_rule,
    dyadic_rows,
    fast_pos,
)

from openintel_tpu.index.schema import DenseIndex
from openintel_tpu.index.synthetic import synthetic_embeddings, synthetic_query_embeddings
from openintel_tpu.models import retrievers as jr
from openintel_tpu.ops.pallas import dense_topk as J
from openintel_tpu_torch import convert
from openintel_tpu_torch.ops import dense_topk as T

DIM = 64
DTYPES = {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _both(emb, q, k, n, dtype, block_c=8192):
    """(JAX vals, ids), (port vals, ids) for the same rows and queries."""
    np_dt, t_dt = DTYPES[dtype]
    jv, ji = J.dense_topk_fast(
        J.pad_corpus_t(jnp.asarray(emb.astype(np_dt).T)),
        jnp.asarray(q.astype(np_dt)), k=k, block_c=block_c, n_docs=n,
        interpret=True,
    )
    tv, ti = T.dense_topk_fast(
        T.pad_corpus_rows(torch.from_numpy(emb).to(t_dt)),
        torch.from_numpy(q).to(t_dt), k=k, block_c=block_c, n_docs=n,
    )
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def _selects_every_column(k, n):
    """True when the reference's approx_max_k takes all candidate columns."""
    cap = -(-n // T._TURBO_UNIT) * 128
    padded = n % T._TURBO_UNIT != 0
    margin = max(128 if padded and n <= 262_144 else 0, 32)
    return min(k, cap) + margin >= cap


@pytest.fixture(scope="module")
def dyadic():
    rng = np.random.default_rng(61)
    return dyadic_rows(rng, 40_000, DIM), dyadic_rows(rng, 9, DIM)


@pytest.mark.parametrize("k", ["8", "32", "capacity+7"])
@pytest.mark.parametrize("b", [3, 9])
@pytest.mark.parametrize("n", [300, 20_000, 40_000])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernel_d_twin_bit_identical_on_dyadic_rows(dyadic, dtype, n, b, k):
    emb, q = dyadic[0][:n], dyadic[1][:b]
    cap = -(-n // T._TURBO_UNIT) * 128
    k = cap + 7 if k == "capacity+7" else int(k)
    (jv, ji), (tv, ti) = _both(emb, q, k, n, dtype)
    assert ti.shape == (b, k) and ti.dtype == np.int32 and tv.dtype == np.float32
    if _selects_every_column(k, n):
        assert_equal_up_to_equal_keys(tv, ti, jv, ji, fast_pos)
    else:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv.view(np.uint32), jv.view(np.uint32))
    if k > cap:  # clamped to the capacity, then padded with (0.0, -1)
        assert (ti[:, cap:] == -1).all() and (tv[:, cap:] == 0).all()
    assert ti.max() < n


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernel_d_twin_quantum_rule_on_random_rows(dtype):
    emb = synthetic_embeddings(20_000, dim=DIM, seed=62)
    q, _ = synthetic_query_embeddings(emb, 9, seed=63)
    np_dt = DTYPES[dtype][0]
    scores = q.astype(np_dt).astype(np.float64) @ emb.astype(np_dt).astype(np.float64).T
    for k in (32, 263):
        (jv, ji), (tv, ti) = _both(emb, q, k, 20_000, dtype)
        assert_quantum_rule(tv, ti, jv, ji, scores)


def test_kernel_d_cells_contract():
    """Each cell is its lane's max key over the super: position bits equal
    the argmax sub-block, and the value bits the truncated score."""
    rng = np.random.default_rng(64)
    emb = torch.from_numpy(dyadic_rows(rng, 20_000, DIM))
    q = torch.from_numpy(dyadic_rows(rng, 32, DIM))
    cells = T.fast_cells_plain(q, T.pad_corpus_rows(emb))
    assert cells.shape == (32, 2 * 128) and cells.dtype == torch.int32
    scores = torch.cat([q @ emb.T, torch.zeros((32, 2 * 16_384 - 20_000))], 1)
    by_cell = scores.view(32, 2, 128, 128)  # (query, super, pos, lane)
    best = by_cell.amax(dim=2).reshape(32, -1)
    vals = (cells & ~127).view(torch.float32) - 2.0
    assert torch.equal(vals, best)  # multiples of 2**-12: no truncation
    pos = (cells & 127).long().view(32, 2, 1, 128)
    assert torch.equal(by_cell.gather(2, pos).reshape(32, -1), best)


@pytest.mark.parametrize("block_c", [128, 4096, 8192, 16_384, 100, 3_000, 32_768])
def test_block_c_accepted_or_refused_as_in_the_reference(block_c):
    emb = dyadic_rows(np.random.default_rng(65), 300, DIM)
    try:
        J.dense_topk_fast(
            J.pad_corpus_t(jnp.asarray(emb.T)), jnp.asarray(emb[:2]), k=4,
            block_c=block_c, n_docs=300, interpret=True,
        )
        ref_ok = True
    except AssertionError:
        ref_ok = False
    if ref_ok:
        T.dense_topk_fast(
            T.pad_corpus_rows(torch.from_numpy(emb)), torch.from_numpy(emb[:2]),
            k=4, block_c=block_c, n_docs=300,
        )
    else:
        with pytest.raises(ValueError, match="block_c"):
            T.dense_topk_fast(
                torch.from_numpy(emb), torch.from_numpy(emb[:2]), k=4,
                block_c=block_c,
            )
    assert ref_ok == (block_c in (128, 4096, 8192, 16_384))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fast_corpus_is_the_padded_transpose_of_the_reference(dtype):
    emb = synthetic_embeddings(20_001, dim=32, seed=66)
    index = DenseIndex.from_embeddings(emb, dtype=DTYPES[dtype][0])
    want = np.asarray(jr.DenseRetriever(index, kernel="fast")._emb_device)
    got = convert.fast_corpus(convert.stored_rows(index, "cpu"))
    assert got.shape == (32_768, 32) and got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(
        got.view(torch.int16 if dtype == "bf16" else torch.int32).numpy(),
        want.T.view(np.int16 if dtype == "bf16" else np.int32),
    )


def test_unpadded_rows_pad_per_call():
    """Rows short of the 16,384 unit are padded inside the call: the same
    result as pre-padded rows with the true n_docs."""
    rng = np.random.default_rng(67)
    emb = torch.from_numpy(dyadic_rows(rng, 700, DIM))
    q = torch.from_numpy(dyadic_rows(rng, 5, DIM))
    a = T.dense_topk_fast(emb, q, k=16)
    b = T.dense_topk_fast(T.pad_corpus_rows(emb), q, k=16, n_docs=700)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
