"""The port's CUDA kernels against their plain twins, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker and
skip without a card. They import no jax; run them on a machine with an
NVIDIA card (sm_90a) and nvcc:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

Tolerances: kernel A's cells are bit-identical to the twin's (integer
arithmetic); kernel B's scores agree to 2e-6 and its ids are equal except
where two docs' scores differ by less than 1e-5.
"""

import numpy as np
import pytest
import torch

from openintel_tpu.index.synthetic import (
    synthetic_embeddings,
    synthetic_postings_index,
    synthetic_query_embeddings,
)
from openintel_tpu_torch import convert
from openintel_tpu_torch.models.retrievers import HybridRetriever
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
    # dim 32: half a k chunk; 640: two passes of five chunks
    [(1, 8192, 128), (2, 4096, 128), (3, 8192, 128), (2, 8192, 32), (3, 4096, 640)],
)
def test_kernel_a_cells_match_twin(cuda, group, block_c, dim):
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_kernel_b_matches_twin(cuda, dtype, k):
    emb = synthetic_embeddings(9_000, dim=96, seed=3)
    q, _ = synthetic_query_embeddings(emb, 21, seed=4)
    d = torch.from_numpy(emb).to(cuda, dtype)
    qq = torch.from_numpy(q).to(cuda, dtype)
    kv, ki = T.fused_topk(d, qq, k)
    pv, pi = T.fused_topk_plain(d, qq, k)
    kv, ki, pv, pi = (t.cpu().numpy() for t in (kv, ki, pv, pi))
    same = ki == pi
    np.testing.assert_allclose(kv[same], pv[same], rtol=0, atol=2e-6)
    assert (np.abs(kv - pv)[~same] < 1e-5).all()


def test_hybrid_int8_path_matches_twins(cuda):
    n = 40_000
    index = synthetic_postings_index(n, vocab_size=2_000, seed=5)
    emb = synthetic_embeddings(n, dim=64, seed=6)
    retr = HybridRetriever(
        index, convert.dense_index(emb, dtype=torch.bfloat16), kernel="int8",
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
