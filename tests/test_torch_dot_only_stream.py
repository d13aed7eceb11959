"""Kernel S on the TMA + wgmma stream (``csrc/dot_only_tma.cu``), on the CPU.

The kernel keeps each lane's sums in the wgmma accumulators: within a run
of sub-blocks the even ones add into one set and the odd ones into the
other, and at the run's end both go into the output by unsigned adds. Its
twin of that order of adds (``dot_only_runs_plain``, int64 sums wrapped as
int32 registers hold them) is held here, bit for bit, to the plain twin
``dot_only_plain`` and to the function of the JAX ``_dot_only_kernel``
(``scripts/bench_kernel_decomp.py``: per 8,192-column step, the int32 sum
of 64 int8 products of 128 columns each, the steps added in int32), on
random and saturated operands, at D 100 (padded to 112), 384 and 1,536,
and at query counts that are not a multiple of 128. The launch plan's
mirror (``dot_only_plan``) is held to its own rules: no run can overflow
int32, and trimming the blocks to share a lane half costs no round of
units. The kernel itself is held to these twins on the card
(``tests/test_torch_cuda_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openintel_tpu.ops.pallas import dense_topk as J
from openintel_tpu_torch.ops import dense_topk as T

UNIT = T._TURBO_UNIT


def _jax_dot_only(q8: np.ndarray, corpus_t: jnp.ndarray) -> np.ndarray:
    """The JAX kernel's function on its (D, N_pad) corpus: per step of
    8,192 columns the int32 sum of its 64 sub-blocks' products, the steps
    added in int32 (wrapping)."""
    block_c, q = 8192, jnp.asarray(q8)

    @jax.jit
    def run(q, e):
        acc = jnp.zeros((q.shape[0], 128), jnp.int32)
        for j in range(e.shape[1] // block_c):
            step = None
            for i in range(block_c // 128):
                lo = j * block_c + i * 128
                s = jax.lax.dot_general(
                    q, e[:, lo : lo + 128], (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32,
                )
                step = s if step is None else step + s
            acc = acc + step
        return acc

    return np.asarray(run(q, corpus_t))


def _operands(data, n, dim, b, seed):
    rng = np.random.default_rng(seed)
    if data == "saturated":  # the largest dots: every lane sum wraps
        return np.full((n, dim), -128, np.int8), np.full((b, dim), -128, np.int8)
    return (
        rng.integers(-128, 128, (n, dim)).astype(np.int8),
        rng.integers(-128, 128, (b, dim)).astype(np.int8),
    )


@pytest.mark.parametrize(
    "data,n,dim,b",
    [
        ("random", 2 * UNIT + 5, 100, 45),  # D padded to 112; 3 supers, the last short
        ("random", UNIT + 300, 384, 37),
        ("saturated", 3 * UNIT, 384, 45),
        ("saturated", UNIT, 1536, 7),
    ],
)
def test_stream_twin_matches_plain_and_the_jax_kernel(data, n, dim, b):
    e8, q8 = _operands(data, n, dim, b, seed=dim + b)
    corpus = T.pad_corpus_rows(T.pad_features(torch.from_numpy(e8)))
    q = T._pad_query_rows(T.pad_features(torch.from_numpy(q8), corpus.shape[1]), 32)
    want = T.dot_only_plain(q, corpus)
    n_super = corpus.shape[0] // UNIT
    for b_pad in (128, 256):  # the plans of one and two query tiles
        plan = T.dot_only_plan(b_pad, n_super, corpus.shape[1])
        for stride in (0, plan["stride"]):
            got, overflows = T.dot_only_runs_plain(
                q, corpus, parts=plan["parts"], stride=stride
            )
            assert torch.equal(got, want) and overflows == 0, (b_pad, stride)
    jax_sums = _jax_dot_only(q8, J.pad_corpus_t_i8(jnp.asarray(e8.T)))
    np.testing.assert_array_equal(want[:b].numpy(), jax_sums)
    if data == "saturated":
        exact = q8.astype(np.int64) @ e8.astype(np.int64).T
        assert (exact.reshape(b, -1, 128).sum(1) != want[:b].numpy()).all()  # wrapped
    np.testing.assert_array_equal(T.dot_only(corpus, torch.from_numpy(q8)).numpy(), jax_sums)


@pytest.mark.parametrize("dim", [384, 1536, 4096])
def test_runs_longer_than_the_rule_would_overflow(dim):
    """With one part a super and runs forced to 128 sub-blocks, all -128
    operands push every set's sum to 64 * 16384 * D, past int32 from
    D=2,048: the twin still wraps to the right sums (modular adds), which
    is what the kernel needs of the tensor cores if the rule is lifted; the
    planned run keeps every set in range."""
    corpus = torch.full((UNIT, dim), -128, dtype=torch.int8)
    q = torch.full((32, dim), -128, dtype=torch.int8)
    want = T.dot_only_plain(q, corpus)
    forced, overflows = T.dot_only_runs_plain(q, corpus, parts=1, run_cap=128)
    assert torch.equal(forced, want)
    assert (overflows > 0) == (64 * 16384 * dim > 2**31 - 1)
    planned, none = T.dot_only_runs_plain(q, corpus, parts=1)
    assert torch.equal(planned, want) and none == 0
    run = T.dot_only_run(dim, 1)  # the longest run that stays in range
    assert run // 2 * dim * 16384 <= 2**31 - 1
    assert run == 128 or run * dim * 16384 > 2**31 - 1


@pytest.mark.parametrize("b_pad", [32, 128, 256, 320, 512])
@pytest.mark.parametrize("n_super", [1, 2, 6, 77])
@pytest.mark.parametrize("dim", [112, 384, 2048, 8192])
def test_plan_keeps_rounds_and_int32(b_pad, n_super, dim):
    """``dot_only_plan``: the run divides the part and no set's sum can
    leave int32 (one run, or every unit of a block when the runs cross
    units); a trimmed grid takes as many rounds of units as the untrimmed
    one and lets each block keep its lane half and part (a multiple of 2
    parts), its supers ``stride`` apart."""
    plan = T.dot_only_plan(b_pad, n_super, dim)
    parts, ctas, run, stride = plan["parts"], plan["ctas_per_qt"], plan["run"], plan["stride"]
    per_part = 128 // parts
    assert per_part % run == 0 and run >= 2 and run & (run - 1) == 0
    units = n_super * 2 * parts
    grid = T._stream_grid(b_pad, n_super, 16, 132)
    assert grid["parts"] == parts
    rounds = -(-units // ctas)
    assert rounds == -(-units // grid["ctas_per_qt"])
    runs_per_set = (rounds * per_part if stride else run) // 2
    assert runs_per_set * dim * 128 * 128 <= 2**31 - 1 or run == 2
    if stride:
        assert run == per_part and ctas % (2 * parts) == 0 and stride == ctas // (2 * parts)
        for cta in range(ctas):  # a block's units: one half, one part
            us = range(cta, units, ctas)
            assert len({(u // parts) & 1 for u in us}) == 1
            assert len({u % parts for u in us}) == 1
            assert [u // (2 * parts) for u in us] == list(range(cta // (2 * parts), n_super, stride))


def test_wrappers_on_the_cpu_run_the_twin_and_check_run_cap():
    rng = np.random.default_rng(5)
    corpus = torch.from_numpy(rng.integers(-128, 128, (UNIT, 64)).astype(np.int8))
    q = torch.from_numpy(rng.integers(-128, 128, (32, 64)).astype(np.int8))
    want = T.dot_only_plain(q, corpus)
    T.reset_launch_counts()
    assert torch.equal(T.dot_only_cells(q, corpus), want)
    assert torch.equal(T.dot_only_cells_v1(q, corpus), want)
    counts = T.launch_counts()
    assert counts["dot_only"] == counts["dot_only_v1"] == 0  # twins launch nothing
    with pytest.raises(ValueError, match="run_cap"):
        T.dot_only_cells(q, corpus, run_cap=129)
