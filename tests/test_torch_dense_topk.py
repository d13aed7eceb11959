"""Port parity: openintel_tpu_torch.ops.dense_topk (and ops.dense, convert)
against the JAX dense kernels.

Inputs are made from a seed with numpy and go through both packages; the
Pallas kernels run in interpret mode, as tests/test_pallas_dense.py runs
them. On CPU tensors the port's wrappers take their plain twins, so these
tests hold the twins to the Pallas kernels; the CUDA kernels are held to the
twins on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).

Tolerances:
- bit-identical: ``quantize_int8``, the bf16 rows (against ``ml_dtypes``),
  the int8 candidate corpus, and kernel A's twin against
  ``dense_topk_fast_i8_grouped`` (vals and ids);
- near-tie rule for kernel B's twin, ``dense_topk_xla`` and
  ``exact_rescore``: scores agree to 2e-6 (float32 sums in another order);
  ids are equal except inside clusters of scores within 1e-5, where the id
  sets agree.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from ranking_utils import assert_ranking_close

from openintel_tpu.index.schema import DenseIndex
from openintel_tpu.index.synthetic import (
    synthetic_embeddings,
    synthetic_query_embeddings,
)
from openintel_tpu.ops import dense as jd
from openintel_tpu.ops import reference as ref
from openintel_tpu.ops.pallas import dense_topk as J
from openintel_tpu_torch import convert
from openintel_tpu_torch.index import schema as tschema
from openintel_tpu_torch.ops import dense as td
from openintel_tpu_torch.ops import dense_topk as T

ATOL = 2e-6
TIE = 1e-5


def _near_tie(vals, ids, ref_vals, ref_ids):
    np.testing.assert_allclose(
        np.asarray(vals), np.asarray(ref_vals), rtol=0, atol=ATOL
    )
    assert_ranking_close(vals, ids, ref_vals, ref_ids, rtol=0, atol=TIE)


# ---- quantisation, bf16 rows, the int8 corpus -----------------------------


def test_quantize_int8_bit_identical():
    rng = np.random.default_rng(11)
    x = synthetic_embeddings(3_000, dim=64, seed=12)
    x[0, :4] = [0.5 / 127, -0.5 / 127, 1.5 / 127, 1.0]  # halves and the clip
    for rows in (x, x.astype(ml_dtypes.bfloat16)):
        want = J.quantize_int8(rows)
        got = T.quantize_int8(convert.stored_rows(
            DenseIndex(embeddings=rows, n_docs=rows.shape[0], dim=64), "cpu"
        ))
        np.testing.assert_array_equal(got.numpy(), want)
    wide = (rng.standard_normal((50, 16)) * 2).astype(np.float32)  # clips
    np.testing.assert_array_equal(
        T.quantize_int8(torch.from_numpy(wide)).numpy(), J.quantize_int8(wide)
    )


def test_bf16_rows_bit_identical_to_ml_dtypes():
    raw = np.random.default_rng(13).standard_normal((500, 48)).astype(np.float32)
    want = DenseIndex.from_embeddings(raw, dtype=ml_dtypes.bfloat16)
    got = tschema.DenseIndex.from_embeddings(raw, dtype=torch.bfloat16)
    assert (got.n_docs, got.dim) == (want.n_docs, want.dim)
    np.testing.assert_array_equal(
        got.embeddings.view(torch.int16).numpy(),
        want.embeddings.view(np.int16),
    )
    # an ml_dtypes index reads through a 16-bit view, bits unchanged
    rows = convert.stored_rows(want, "cpu")
    assert rows.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        rows.view(torch.int16).numpy(), want.embeddings.view(np.int16)
    )
    f32 = convert.stored_rows(DenseIndex.from_embeddings(raw), "cpu")
    np.testing.assert_array_equal(
        f32.numpy(), DenseIndex.from_embeddings(raw).embeddings
    )


def test_int8_corpus_is_the_padded_transpose_of_the_reference():
    emb = synthetic_embeddings(20_000, dim=32, seed=14).astype(ml_dtypes.bfloat16)
    want = np.asarray(J.pad_corpus_t_i8(jnp.asarray(J.quantize_int8(emb).T)))
    rows = convert.stored_rows(
        DenseIndex(embeddings=emb, n_docs=20_000, dim=32), "cpu"
    )
    got = convert.int8_corpus(rows, chunk=7_000)
    assert got.shape == (32_768, 32) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want.T)


# ---- kernel A: int8 candidate cells ---------------------------------------

N_A = 2 * J._TURBO_UNIT + 7_000  # 3 supers, the last one short
B_A = 37  # pads to 64


@pytest.fixture(scope="module")
def i8_operands():
    emb = synthetic_embeddings(N_A, dim=64, seed=21)
    q, _ = synthetic_query_embeddings(emb, B_A, seed=22)
    e8 = J.quantize_int8(emb)
    q8 = J.quantize_int8(q)
    rng = np.random.default_rng(23)  # entries in {-1, 0, 1}: equal keys abound
    tie_e = rng.integers(-1, 2, size=(N_A, 32)).astype(np.int8)
    tie_q = rng.integers(-1, 2, size=(B_A, 32)).astype(np.int8)
    return {
        "random": (e8, q8),
        "ties": (tie_e, tie_q),
    }


def _i8_both(e8, q8, k, block_c, group):
    jv, ji = J.dense_topk_fast_i8_grouped(
        J.pad_corpus_t_i8(jnp.asarray(e8.T)), jnp.asarray(q8), k=k,
        block_c=block_c, n_docs=N_A, interpret=True, group=group,
    )
    tv, ti = T.dense_topk_fast_i8_grouped(
        T.pad_corpus_rows(torch.from_numpy(e8)), torch.from_numpy(q8), k=k,
        block_c=block_c, n_docs=N_A, group=group,
    )
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("block_c", [4096, 8192])
@pytest.mark.parametrize("group", [1, 2, "auto"])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_kernel_a_twin_bit_identical(i8_operands, data, group, block_c):
    """Every candidate of every (lane, group) cell, in order: k is the full
    candidate width, so the comparison covers each cell's keys and super
    labels (the fold's tie rules included)."""
    e8, q8 = i8_operands[data]
    group = T.auto_i8_group(N_A, 32) if group == "auto" else group
    assert group == J.auto_i8_group(N_A, 32) or group in (1, 2)
    width = 2 * (-(-3 // group)) * 128
    (jv, ji), (tv, ti) = _i8_both(e8, q8, width, block_c, group)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv.view(np.uint32), jv.view(np.uint32))
    assert ti.shape == (B_A, width) and ti.max() < N_A


@pytest.mark.parametrize("k", [10, 32, 1_000])
def test_kernel_a_twin_small_k_and_clamp(i8_operands, k):
    """k below the width, and k beyond it (clamped, then padded with
    (0.0, -1) back to the requested k)."""
    e8, q8 = i8_operands["random"]
    (jv, ji), (tv, ti) = _i8_both(e8, q8, k, 8192, 2)
    assert ti.shape == (B_A, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv.view(np.uint32), jv.view(np.uint32))
    if k == 1_000:
        assert (ti[:, 512:] == -1).all() and (tv[:, 512:] == 0).all()


def test_kernel_a_cells_contract():
    """The raw cells: the two keys of a cell are real keys (flag-biased,
    slot 1 first) and each super label lies inside its group."""
    rng = np.random.default_rng(24)
    e8 = torch.from_numpy(J.quantize_int8(synthetic_embeddings(40_000, 64, seed=25)))
    q8 = torch.from_numpy(J.quantize_int8(
        rng.standard_normal((32, 64)).astype(np.float32) / 8.0
    ))
    corpus = T.pad_corpus_rows(e8)
    k1, k2, s1, s2 = T.i8_top2g_cells_plain(q8, corpus, group=2, sub=64)
    assert k1.shape == (32, 2 * 128) and k1.dtype == torch.int32
    assert (k1 >= k2).all() and (k2 > T._I8_FLAG128 - 2**21).all()
    assert ((s1[:, :128] < 2) & (s1[:, 128:] == 2)).all()
    assert ((s2[:, :128] < 2) & (s2[:, 128:] == 2)).all()


# ---- kernel B: exact fused cosine top-k -----------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [10, 32])
def test_kernel_b_twin_matches_pallas_and_reference(dtype, k):
    emb = synthetic_embeddings(3_000, dim=64, seed=31)
    q, _ = synthetic_query_embeddings(emb, 19, seed=32)
    if dtype == "bf16":
        emb = emb.astype(ml_dtypes.bfloat16)
        q = q.astype(ml_dtypes.bfloat16)
    jv, ji = J.dense_topk_pallas(
        jnp.asarray(emb), jnp.asarray(q), k=k, block_q=8, block_c=512,
        interpret=True,
    )
    rows = convert.stored_rows(
        DenseIndex(embeddings=emb, n_docs=3_000, dim=64), "cpu"
    )
    qt = convert.stored_rows(DenseIndex(embeddings=q, n_docs=19, dim=64), "cpu")
    tv, ti = T.dense_topk_pallas(rows, qt, k=k)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    _near_tie(tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji))
    if dtype == "f32":  # the oracle re-normalises: bf16 rows are not unit
        rv, ri = ref.cosine_topk(emb, q, k)
        _near_tie(tv.numpy(), ti.numpy(), rv, ri)


def test_kernel_b_twin_k_beyond_corpus_and_duplicates():
    base = synthetic_embeddings(64, dim=32, seed=33)
    emb = np.concatenate([base, base])  # doc i == doc i + 64
    tv, ti = T.dense_topk_pallas(torch.from_numpy(emb), torch.from_numpy(base[:2]), k=2)
    assert ti.tolist() == [[0, 64], [1, 65]]
    small = synthetic_embeddings(5, dim=32, seed=34)
    q = synthetic_embeddings(3, dim=32, seed=35)
    jv, ji = J.dense_topk_pallas(
        jnp.asarray(small), jnp.asarray(q), k=8, block_q=8, block_c=128,
        interpret=True,
    )
    tv, ti = T.dense_topk_pallas(torch.from_numpy(small), torch.from_numpy(q), k=8)
    assert ti.shape == (3, 8) and (ti[:, 5:] == -1).all() and (tv[:, 5:] == 0).all()
    _near_tie(tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji))
    with pytest.raises(ValueError):
        T.dense_topk_pallas(torch.from_numpy(small), torch.from_numpy(q), k=1025)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_topk_xla_matches_jax(dtype):
    emb = synthetic_embeddings(5_000, dim=48, seed=41)
    q, _ = synthetic_query_embeddings(emb, 9, seed=42)
    if dtype == "bf16":
        emb, q = emb.astype(ml_dtypes.bfloat16), q.astype(ml_dtypes.bfloat16)
    jv, ji = jd.dense_topk_xla(jnp.asarray(emb), jnp.asarray(q), 16, block_size=1024)
    rows = convert.stored_rows(DenseIndex(embeddings=emb, n_docs=5_000, dim=48), "cpu")
    qt = convert.stored_rows(DenseIndex(embeddings=q, n_docs=9, dim=48), "cpu")
    tv, ti = td.dense_topk_xla(rows, qt, 16, block_size=1024)
    _near_tie(tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji))


# ---- exact rescore --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_exact_rescore_matches_jax(dtype):
    rng = np.random.default_rng(51)
    emb = synthetic_embeddings(4_000, dim=64, seed=52)
    q, _ = synthetic_query_embeddings(emb, 12, seed=53)
    cand = rng.integers(0, 4_000, size=(12, 40)).astype(np.int32)
    cand[:, -6:] = -1  # padding
    cand[3, :20] = -1  # a row with few candidates
    cand[4, :] = -1  # no candidates at all
    cand[5, 1] = cand[5, 0]  # a repeated candidate
    emb_j = emb.astype(ml_dtypes.bfloat16) if dtype == "bf16" else emb
    for k in (10, 45):
        jv, ji = J.exact_rescore(jnp.asarray(emb_j), jnp.asarray(q), jnp.asarray(cand), k)
        rows = convert.stored_rows(
            DenseIndex(embeddings=emb_j, n_docs=4_000, dim=64), "cpu"
        )
        tv, ti = T.exact_rescore(rows, torch.from_numpy(q), torch.from_numpy(cand), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
        assert (ti[4] == -1).all() and (tv[4] == 0).all()


# ---- wrappers: CPU tensors take the twin, nothing else falls back ---------


NO_LAUNCHES = {
    "i8_top2g": 0, "i8_top2g_v1": 0, "i8_fold": 0, "fused_topk": 0, "fused_topk_v1": 0,
    "turbo_f32": 0, "turbo_f32_v1": 0, "turbo_i4": 0, "turbo_i4_top2": 0,
    "turbo_i4_v1": 0, "turbo_i4_top2_v1": 0, "turbo_i8": 0, "turbo_i8_top2": 0,
    "turbo_i8_v1": 0, "turbo_i8_top2_v1": 0, "dot_only": 0, "dot_only_v1": 0,
}


def test_wrappers_route_cpu_to_twins_without_counting():
    T.reset_launch_counts()
    q = torch.zeros((32, 16), dtype=torch.int8)
    corpus = torch.zeros((T._TURBO_UNIT, 16), dtype=torch.int8)
    cells = T.i8_top2g_cells(q, corpus, group=1, sub=64)
    assert all(c.shape == (32, 128) for c in cells)
    assert all(c.shape == (32, 128) for c in T.i8_top2g_cells_v1(q, corpus, group=1, sub=64))
    steps = T.i8_step_tops_plain(q, corpus, sub=64)
    assert all(c.shape == (32, 128) for c in T.i8_fold_steps(steps, n_super=1, group=1, sub=64))
    T.fused_topk(torch.eye(4), torch.eye(4), 2)
    T.fused_topk_v1(torch.eye(4), torch.eye(4), 2)
    assert T.fast_cells(q.float(), corpus.float()).shape == (32, 128)
    assert T.fast_cells_v1(q.bfloat16(), corpus.bfloat16()).shape == (32, 128)
    packed = corpus[: T._TURBO_UNIT // 2]
    for slots in (1, 2):
        assert T.i4_cells(q, packed, slots=slots).shape == (32, 128 * slots)
        assert T.i4_cells_v1(q, packed, slots=slots).shape == (32, 128 * slots)
        assert T.i8_turbo_cells(q, corpus, slots=slots).shape == (32, 128 * slots)
        assert T.i8_turbo_cells_v1(q, corpus, slots=slots).shape == (32, 128 * slots)
    assert T.dot_only_cells(q, corpus).shape == (32, 128)
    assert T.dot_only_cells_v1(q, corpus).shape == (32, 128)
    assert T.launch_counts() == NO_LAUNCHES


def test_wrappers_refuse_non_cuda_devices():
    """A tensor that is neither on the CPU nor on a CUDA device raises: the
    wrappers never route anything but CPU tensors to a twin."""
    q = torch.empty((32, 16), dtype=torch.int8, device="meta")
    corpus = torch.empty((T._TURBO_UNIT, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        T.i8_top2g_cells(q, corpus, group=1, sub=64)
    with pytest.raises(ValueError, match="CUDA"):
        T.fused_topk(torch.empty((4, 4), device="meta"), torch.empty((2, 4)), 2)
    with pytest.raises(ValueError, match="CUDA"):
        T.fused_topk_v1(torch.empty((4, 4), device="meta"), torch.empty((2, 4)), 2)
    with pytest.raises(ValueError, match="CUDA"):
        T.fast_cells(q.float(), corpus.float())
    with pytest.raises(ValueError, match="CUDA"):
        T.i8_top2g_cells_v1(q, corpus, group=1, sub=64)
    with pytest.raises(ValueError, match="CUDA"):
        T.i8_fold_steps(torch.empty((2, 32, 128, 2), dtype=torch.int32, device="meta"),
                        n_super=1, group=1, sub=64)
    with pytest.raises(ValueError, match="CUDA"):
        T.fast_cells_v1(q.bfloat16(), corpus.bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        T.i4_cells(q, corpus[: T._TURBO_UNIT // 2], slots=2)
    with pytest.raises(ValueError, match="CUDA"):
        T.i4_cells_v1(q, corpus[: T._TURBO_UNIT // 2], slots=2)
    with pytest.raises(ValueError, match="CUDA"):
        T.i8_turbo_cells(q, corpus, slots=2)
    with pytest.raises(ValueError, match="CUDA"):
        T.i8_turbo_cells_v1(q, corpus, slots=2)
    with pytest.raises(ValueError, match="CUDA"):
        T.dot_only_cells(q, corpus)
    with pytest.raises(ValueError, match="CUDA"):
        T.dot_only_cells_v1(q, corpus)
    assert T.launch_counts() == NO_LAUNCHES
