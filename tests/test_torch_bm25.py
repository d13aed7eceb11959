"""Port parity: openintel_tpu_torch.ops.bm25 against openintel_tpu.ops.bm25.

Tolerance: bit-identical. The copied host planner gives the same plan on
its native (C++) and NumPy routes; the device reduction adds in the same
order as the JAX program, so its values and ids are equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openintel_tpu import native
from openintel_tpu.index.synthetic import synthetic_postings_index
from openintel_tpu.ops import bm25 as jb
from openintel_tpu.ops import reference as ref
from openintel_tpu_torch import native as tnative
from openintel_tpu_torch.ops import bm25 as tb


@pytest.fixture(scope="module")
def idx():
    return synthetic_postings_index(6_000, vocab_size=300, mean_len=12, seed=61)


@pytest.fixture(scope="module")
def native_lib():
    """The reference's native library and the port's own copy, both built."""
    for lib in (native, tnative):
        lib.build()
        if lib._load() is None:  # pragma: no cover - toolchain always present
            pytest.skip("native library unavailable")
    return True


def _queries(seed, n, t=4, hi=120):
    rng = np.random.default_rng(seed)
    qs = [list(rng.integers(1, hi, size=t)) for _ in range(n)]
    qs[0] = qs[0] + qs[0][:1]  # a repeated term (query tf 2)
    qs[-1] = []  # an empty query
    return qs


def _assert_plans_equal(a, b):
    np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
    np.testing.assert_array_equal(
        a.weights.view(np.uint32), b.weights.view(np.uint32)
    )
    assert (a.n_docs, a.presorted, a.max_terms) == (
        b.n_docs, b.presorted, b.max_terms,
    )


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("prune", [None, 32])
def test_build_query_plan_copy_matches_original(idx, native_lib, use_native, prune):
    qs = _queries(1, 9)
    kw = dict(max_postings_per_term=prune, multi_budget=16, use_native=use_native)
    _assert_plans_equal(
        tb.build_query_plan(idx, qs, **kw), jb.build_query_plan(idx, qs, **kw)
    )


def test_unsorted_plan_copy_matches_original(idx):
    qs = _queries(2, 5)
    _assert_plans_equal(
        tb.build_query_plan(idx, qs, sort=False),
        jb.build_query_plan(idx, qs, sort=False),
    )


def test_bucket_and_encode_query_match(idx):
    for w in (1, 511, 512, 513, 768, 769, 5000):
        assert tb._bucket(w) == jb._bucket(w)
    for text in ("t1 t7 unknown T12", "", "t299 t299"):
        assert tb.encode_query(idx, text) == jb.encode_query(idx, text)


@pytest.mark.parametrize("k", [1, 10, 64, 700])
@pytest.mark.parametrize("prune", [None, 16])
def test_bm25_topk_device_bit_identical(idx, k, prune):
    qs = _queries(3 + k, 12)
    plan = jb.build_query_plan(idx, qs, max_postings_per_term=prune)
    jv, ji = jb.bm25_topk_device(
        jnp.asarray(plan.doc_ids), jnp.asarray(plan.weights), plan.n_docs, k,
        presorted=plan.presorted, max_run=plan.max_terms,
    )
    tv, ti = tb.bm25_topk_device(
        torch.from_numpy(plan.doc_ids), torch.from_numpy(plan.weights),
        plan.n_docs, k, presorted=plan.presorted, max_run=plan.max_terms,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        tv.numpy().view(np.uint32), np.asarray(jv).view(np.uint32)
    )
    assert ti.dtype == torch.int32 and ti.shape == (12, k)


def test_bm25_topk_device_unbounded_run_and_unsorted_plan(idx):
    """max_run=0 (unbounded scan) and a plan the device must sort first."""
    qs = _queries(4, 6)
    plan = jb.build_query_plan(idx, qs, sort=False)
    jv, ji = jb.bm25_topk_device(
        jnp.asarray(plan.doc_ids), jnp.asarray(plan.weights), plan.n_docs, 10,
    )
    tv, ti = tb.bm25_topk_device(
        torch.from_numpy(plan.doc_ids), torch.from_numpy(plan.weights),
        plan.n_docs, 10,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    for row, q in enumerate(qs):
        rv, ri = ref.bm25_topk(idx, q, 10)
        np.testing.assert_allclose(tv.numpy()[row], rv, rtol=1e-5, atol=1e-6)
