"""Operands and comparison rules shared by the port's candidate-kernel tests
(kernels C, D and E against the JAX package)."""

import numpy as np

QUANTUM = 2.0**-15  # kernel D's score step for s + 2 in [2, 4) (2**-16 below)


def dyadic_rows(rng, n: int, dim: int) -> np.ndarray:
    """Unit rows rounded to multiples of 2**-6: exact in bf16, and every
    partial sum of a dot of two such rows is exact in float32, so the sum
    order does not matter."""
    x = rng.standard_normal((n, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return (np.round(x * 64.0) / 64.0).astype(np.float32)


def fast_pos(ids: np.ndarray) -> np.ndarray:
    """Kernel C's and D's key position of each doc id (its 128-doc
    sub-block)."""
    return np.where(ids >= 0, (ids // 128) % 128, -1)


def i4_pos(ids: np.ndarray) -> np.ndarray:
    """Kernel E's key position of each doc id (2 * byte sub-tile + parity)."""
    return np.where(ids >= 0, 2 * ((ids % 16_384) // 256) + (ids & 1), -1)


def assert_equal_up_to_equal_keys(vals, ids, ref_vals, ref_ids, pos_of):
    """Values bit-identical; at each rank the same key (value, position);
    ids equal as sets within each run of equal keys. The rule for a
    reference that orders equal keys arbitrarily (``approx_max_k`` on the
    CPU when it selects every column)."""
    vals, ids = np.asarray(vals), np.asarray(ids)
    ref_vals, ref_ids = np.asarray(ref_vals), np.asarray(ref_ids)
    np.testing.assert_array_equal(vals.view(np.uint32), ref_vals.view(np.uint32))
    np.testing.assert_array_equal(pos_of(ids), pos_of(ref_ids))
    for row in range(ids.shape[0]):
        key = list(zip(vals[row].view(np.uint32).tolist(), pos_of(ids[row]).tolist()))
        got = sorted(zip(key, ids[row].tolist()))
        want = sorted(zip(key, ref_ids[row].tolist()))
        assert got == want, f"row {row}: ids differ beyond equal keys"


def assert_quantum_rule(vals, ids, ref_vals, ref_ids, scores, quantum=QUANTUM):
    """Kernel D on non-dyadic operands, where a sum order moves a cell by
    one score step. ``scores``: (B, N) exact float64 scores of the operands.

    - values within ``quantum`` at every rank;
    - in both lists each id carries its own score: its value v is its exact
      score s truncated to a step, v <= s < v + quantum (up to the float32
      sum's rounding), so ids that differ at a rank belong to docs whose
      exact scores lie within 2 * quantum of each other;
    - no id twice in a row.

    Returns the number of ranks whose ids differ."""
    vals, ids = np.asarray(vals, np.float64), np.asarray(ids)
    ref_vals, ref_ids = np.asarray(ref_vals, np.float64), np.asarray(ref_ids)
    assert ids.shape == ref_ids.shape
    gap = np.abs(vals - ref_vals)
    assert gap.max(initial=0.0) <= quantum, gap.max()
    eps = 1e-6  # float32 sums of unit-row products
    for v, i in ((vals, ids), (ref_vals, ref_ids)):
        real = i >= 0
        s = np.take_along_axis(scores, np.where(real, i, 0), axis=1)
        under = (s - v)[real]
        assert under.min(initial=0.0) >= -eps and under.max(initial=0.0) < quantum + eps
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == real.size, row
    return int((ids != ref_ids).sum())
