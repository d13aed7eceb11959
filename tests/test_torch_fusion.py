"""Port parity: openintel_tpu_torch.ops.fusion against the JAX fusion ops.

Inputs are made from a seed with numpy and go through both
implementations. Tolerance: fused ids are bit-identical (ties, padding and
fewer candidates than k included); fused values agree to 1e-6 (the z-blend
sums its arms in another order than XLA).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from ranking_utils import assert_ranking_close

from openintel_tpu.ops import fusion as jf
from openintel_tpu.ops import reference as ref
from openintel_tpu_torch.ops import fusion as tf


def _arm(rng, b, width, n_ids, n_valid_min, ties):
    """(vals, ids): per row a ranked list of distinct ids, descending
    scores, trailing (0.0, -1) padding."""
    ids = np.full((b, width), -1, np.int32)
    vals = np.zeros((b, width), np.float32)
    for i in range(b):
        n = int(rng.integers(n_valid_min, width + 1))
        ids[i, :n] = rng.choice(n_ids, size=n, replace=False)
        v = rng.uniform(0.0, 10.0, size=n).astype(np.float32)
        if ties:  # coarse grid: many exactly equal scores
            v = np.round(v * 2) / 2
        vals[i, :n] = np.sort(v)[::-1]
    return vals, ids


CASES = [
    # (b, width_a, width_b, n_ids, k, ties)
    (8, 16, 16, 40, 10, False),
    (8, 16, 16, 20, 10, True),  # heavy overlap and exact score ties
    (5, 4, 3, 30, 10, False),  # fewer candidates than k: padded columns
    (6, 12, 20, 1000, 7, True),
]


@pytest.mark.parametrize("b,wa,wb,n_ids,k,ties", CASES)
def test_rrf_matches_jax(b, wa, wb, n_ids, k, ties):
    rng = np.random.default_rng(100 + b + wa)
    _, ia = _arm(rng, b, wa, n_ids, 0, ties)
    _, ib = _arm(rng, b, wb, n_ids, 0, ties)
    jv, ji = jf.rrf_fuse_device(jnp.asarray(ia), jnp.asarray(ib), k)
    tv, ti = tf.rrf_fuse_device(torch.from_numpy(ia), torch.from_numpy(ib), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32


@pytest.mark.parametrize("b,wa,wb,n_ids,k,ties", CASES)
def test_zblend_matches_jax(b, wa, wb, n_ids, k, ties):
    rng = np.random.default_rng(200 + b + wb)
    va, ia = _arm(rng, b, wa, n_ids, 0, ties)
    vb, ib = _arm(rng, b, wb, n_ids, 0, ties)
    jv, ji = jf.zblend_fuse_device(
        jnp.asarray(va), jnp.asarray(ia), jnp.asarray(vb), jnp.asarray(ib), k
    )
    tv, ti = tf.zblend_fuse_device(
        torch.from_numpy(va), torch.from_numpy(ia),
        torch.from_numpy(vb), torch.from_numpy(ib), k,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    assert np.isfinite(tv.numpy()).all()


def test_zblend_matches_reference_oracle():
    rng = np.random.default_rng(7)
    va, ia = _arm(rng, 4, 10, 25, 10, False)
    vb, ib = _arm(rng, 4, 10, 25, 10, False)
    tv, ti = tf.zblend_fuse_device(
        torch.from_numpy(va), torch.from_numpy(ia),
        torch.from_numpy(vb), torch.from_numpy(ib), 10,
    )
    # the oracle sums in float64: near-tied positions may swap
    rv, ri = ref.zblend_fuse(va, ia, vb, ib, 10)
    assert_ranking_close(tv.numpy(), ti.numpy(), rv, ri, rtol=1e-5, atol=1e-5)


def test_zblend_padded_arm_is_not_nan():
    """An arm of padding only (ids -1 with -inf scores) fills with 0 and
    must not poison the fused scores (0 * -inf is NaN)."""
    ia = torch.tensor([[3, 1, -1]], dtype=torch.int32)
    va = torch.tensor([[2.0, 1.0, float("-inf")]])
    ib = torch.full((1, 3), -1, dtype=torch.int32)
    vb = torch.full((1, 3), float("-inf"))
    vals, ids = tf.zblend_fuse_device(va, ia, vb, ib, 4)
    assert ids.tolist() == [[3, 1, -1, -1]]
    assert torch.isfinite(vals).all()
