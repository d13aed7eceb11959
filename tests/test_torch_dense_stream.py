"""Kernel A's two stages, as the Hopper kernel (``csrc/i8_top2g_tma.cu``)
runs them: per-step top-2 keys (``i8_step_tops_plain``), then each group's
steps folded in ascending order (``i8_fold_steps_plain``).

Tolerance: bit-identical. The composition is held to kernel A's plain twin
(``i8_top2g_cells_plain``) cell by cell, and through
``dense_topk_fast_i8_grouped`` to the JAX kernel in interpret mode (the
full candidate width, so every cell's keys and super labels count). One
test shows why the fold stays sequential: a tree merge of group states
gives other super labels on a crafted three-step tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openintel_tpu.index.synthetic import synthetic_embeddings, synthetic_query_embeddings
from openintel_tpu.ops.pallas import dense_topk as J
from openintel_tpu_torch.ops import dense_topk as T

N_SUPER = 4
N = (N_SUPER - 1) * T._TURBO_UNIT + 7_000  # the last super short
B = 37  # pads to 64


@pytest.fixture(scope="module")
def operands():
    emb = synthetic_embeddings(N, dim=32, seed=61)
    q, _ = synthetic_query_embeddings(emb, B, seed=62)
    rng = np.random.default_rng(63)  # entries in {-1, 0, 1}: equal keys abound
    return {
        "random": (J.quantize_int8(emb), J.quantize_int8(q)),
        "ties": (
            rng.integers(-1, 2, size=(N, 32)).astype(np.int8),
            rng.integers(-1, 2, size=(B, 32)).astype(np.int8),
        ),
    }


def _padded(e8, q8):
    corpus = T.pad_corpus_rows(torch.from_numpy(e8))
    q = torch.cat([torch.from_numpy(q8), torch.zeros((64 - B, 32), dtype=torch.int8)])
    return q, corpus


def two_stage_plain(queries, corpus, *, group, sub):
    steps = T.i8_step_tops_plain(queries, corpus, sub=sub)
    n_super = corpus.shape[0] // T._TURBO_UNIT
    return T.i8_fold_steps_plain(steps, n_super=n_super, group=group, sub=sub)


@pytest.mark.parametrize("sub", [1, 2, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 3])  # 3: a short last group
@pytest.mark.parametrize("data", ["random", "ties"])
def test_two_stages_equal_the_cells_twin(operands, data, group, sub):
    q, corpus = _padded(*operands[data])
    got = two_stage_plain(q, corpus, group=group, sub=sub)
    want = T.i8_top2g_cells_plain(q, corpus, group=group, sub=sub)
    for name, g, w in zip(("k1", "k2", "s1", "s2"), got, want):
        assert torch.equal(g, w), name
    # the CPU wrapper of the fold stage takes its twin
    steps = T.i8_step_tops_plain(q, corpus, sub=sub)
    for g, w in zip(T.i8_fold_steps(steps, n_super=N_SUPER, group=group, sub=sub), want):
        assert torch.equal(g, w)


def test_step_tops_layout(operands):
    """Entry (t, b, lane): the top-2 keys of step t's sub-blocks, slot 1
    first; one sub-block per step leaves the sentinel 0 in slot 2."""
    q, corpus = _padded(*operands["random"])
    steps = T.i8_step_tops_plain(q, corpus, sub=2)
    assert steps.shape == (N_SUPER * 64, 64, 128, 2) and steps.dtype == torch.int32
    dots = (q.float() @ corpus.float().T).to(torch.int32)  # (64, N_pad)
    t, b, lane = 70, 5, 33  # super 1, sub-blocks 12 and 13
    keys = [int(dots[b, 16_384 + 128 * p + lane]) * 128 + T._I8_FLAG128 + p for p in (12, 13)]
    assert steps[t, b, lane].tolist() == sorted(keys, reverse=True)
    ones = T.i8_step_tops_plain(q, corpus, sub=1)
    assert (ones[..., 1] == 0).all() and torch.equal(ones[..., 0].max(), steps[..., 0].max())


@pytest.mark.parametrize("block_c", [128, 4096, 8192])
@pytest.mark.parametrize("group", [1, 2, "auto"])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_two_stages_match_the_jax_kernel(operands, monkeypatch, data, group, block_c):
    """Through ``dense_topk_fast_i8_grouped`` at the full candidate width,
    against the Pallas kernel in interpret mode."""
    e8, q8 = operands[data]
    group = T.auto_i8_group(N, 32) if group == "auto" else group
    width = 2 * (-(-N_SUPER // group)) * 128
    jv, ji = J.dense_topk_fast_i8_grouped(
        J.pad_corpus_t_i8(jnp.asarray(e8.T)), jnp.asarray(q8), k=width,
        block_c=block_c, n_docs=N, interpret=True, group=group,
    )
    monkeypatch.setattr(T, "i8_top2g_cells_plain", two_stage_plain)
    tv, ti = T.dense_topk_fast_i8_grouped(
        T.pad_corpus_rows(torch.from_numpy(e8)), torch.from_numpy(q8), k=width,
        block_c=block_c, n_docs=N, group=group, plain=True,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), np.asarray(jv).view(np.uint32))


def _merge(state, step):
    """The reference's merge of a group state (g1, g2, s1, s2) with a later
    state or step (a1, a2, t1, t2); a step's labels are its own super."""
    g1, g2, s1, s2 = state
    a1, a2, t1, t2 = step
    upd1 = a1 > g1
    m = min(g1, a1)  # displaced slot-1 loser
    sup_m = s1 if upd1 else t1
    c2 = max(g2, a2)
    sup_c2 = t2 if a2 > g2 else s2
    return (max(g1, a1), max(m, c2), t1 if upd1 else s1, sup_m if m >= c2 else sup_c2)


def test_tree_merge_of_group_states_differs_from_the_ordered_fold():
    """Three steps (supers 0, 1, 2) share slot-1 key X. In order the fold
    ends with super labels (0, 2); merging (s0, merge(s1, s2)) as a tree
    gives (0, 1). So a group's steps may not be split into partial states
    merged afterwards: stage 2 folds each group's steps in order."""
    x, y = T._I8_FLAG128 + 1000 * 128 + 5, T._I8_FLAG128 + 10 * 128 + 7
    steps = [(x, y + 128 * t, t, t) for t in range(3)]
    ordered = steps[0]
    for st in steps[1:]:
        ordered = _merge(ordered, st)
    tree = _merge(steps[0], _merge(steps[1], steps[2]))
    assert ordered[2:] == (0, 2) and tree[2:] == (0, 1)
    assert ordered[:2] == tree[:2] == (x, x)
    # the fold twin takes the ordered path: one query, lane 0, sub 128
    t = torch.zeros((3, 32, 128, 2), dtype=torch.int32)
    for i, (a1, a2, _, _) in enumerate(steps):
        t[i, :, :, 0], t[i, :, :, 1] = a1, a2
    k1, k2, s1, s2 = T.i8_fold_steps_plain(t, n_super=3, group=3, sub=128)
    assert (int(k1[0, 0]), int(k2[0, 0]), int(s1[0, 0]), int(s2[0, 0])) == (x, x, 0, 2)
