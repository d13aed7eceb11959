"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have: half of each batch left out (its rows a copy
of the other half's), an answer altered where it is produced, a step that
hands back the previous step's result; and on a live corpus, a wave
served from the epoch before the last write, a deleted id served (the
delete acknowledged and dropped), an add acknowledged and dropped. (One
card: no exchange between cards to leave out.) The chip's look is
skipped: the toy cells run on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import run_toy


def _half_batch(out):
    vals, ids = out[0].clone(), out[1].clone()
    n = vals.shape[-2]
    h = (n + 1) // 2
    vals[..., h:, :] = vals[..., : n - h, :]
    ids[..., h:, :] = ids[..., : n - h, :]
    return (vals, ids) + tuple(out[2:])


def _break_half_batch_hybrid(mp):
    from openintel_tpu_torch.models import retrievers

    orig = retrievers.HybridRetriever.run_prepared_device
    mp.setattr(retrievers.HybridRetriever, "run_prepared_device",
               lambda self, prep, **kw: _half_batch(orig(self, prep, **kw)))


def _break_half_batch_dense(mp):
    from openintel_tpu_torch.models import retrievers

    orig = retrievers.DenseRetriever.search_embeddings

    def half(self, q, k=10, **kw):
        res = orig(self, q, k, **kw)
        n = len(res.ids)
        h = (n + 1) // 2
        res.ids[h:] = res.ids[: n - h]
        res.scores[h:] = res.scores[: n - h]
        return res

    mp.setattr(retrievers.DenseRetriever, "search_embeddings", half)


def _break_fusion(mp):
    from openintel_tpu_torch.models import retrievers

    orig = retrievers.zblend_fuse_device

    def swapped(*a, **kw):
        vals, ids = orig(*a, **kw)
        return vals, ids[:, [1, 0] + list(range(2, ids.shape[1]))]

    mp.setattr(retrievers, "zblend_fuse_device", swapped)


def _break_rescore(mp):
    from openintel_tpu_torch.models import retrievers

    orig = retrievers.exact_rescore
    mp.setattr(retrievers, "exact_rescore",
               lambda *a, **kw: (lambda v, i: (v + 1e-3 * (i >= 0), i))(*orig(*a, **kw)))


def _break_stale_step(mp):
    from openintel_tpu_torch.models import retrievers

    orig = retrievers.HybridRetriever.finalize_prepared
    last = {}

    def stale(self, prep, out):
        res = orig(self, prep, out)
        prev = last.get("res", res)
        last["res"] = res
        return prev

    mp.setattr(retrievers.HybridRetriever, "finalize_prepared", stale)


def _break_stale_epoch(mp):
    from openintel_tpu_torch.models import updatable

    cls = updatable.UpdatableHybridRetriever

    def keeping_the_last(write):
        def wrapped(self, *a, **kw):
            self._before_last_write = self._st
            return write(self, *a, **kw)
        return wrapped

    for name in ("add_documents", "delete_ids"):
        mp.setattr(cls, name, keeping_the_last(getattr(cls, name)))
    mp.setattr(cls, "search", lambda self, queries, k=10, **kw: self._search_epoch(
        getattr(self, "_before_last_write", self._st), queries, k, **kw))


def _break_deleted_served(mp):
    from openintel_tpu_torch.models import updatable

    mp.setattr(updatable.UpdatableHybridRetriever, "delete_ids", lambda self, ids: None)


def _break_dropped_add(mp):
    from openintel_tpu_torch.models import updatable

    orig = updatable.UpdatableHybridRetriever.add_documents
    calls = []

    def add(self, texts, embeddings=None):
        calls.append(len(texts))
        if len(calls) == 2:  # acknowledged with the ids it would get, and dropped
            n = self.n_docs
            return np.arange(n, n + len(texts))
        return orig(self, texts, embeddings)

    mp.setattr(updatable.UpdatableHybridRetriever, "add_documents", add)


FAULTS = [
    ("hybrid-batch", _break_half_batch_hybrid),
    ("hybrid-batch", _break_fusion),
    ("hybrid-batch", _break_stale_step),
    ("filtered-batch", _break_half_batch_hybrid),
    ("filtered-batch", _break_fusion),
    ("requests", _break_fusion),
    ("requests", _break_half_batch_hybrid),
    ("dense-batch", _break_half_batch_dense),
    ("dense-batch", _break_rescore),
    ("live", _break_stale_epoch),
    ("live", _break_deleted_served),
    ("live", _break_dropped_add),
]


@pytest.mark.parametrize("mix,fault", FAULTS, ids=[f"{m}-{f.__name__[7:]}" for m, f in FAULTS])
def test_broken_path_is_not_correct(toy_root, monkeypatch, mix, fault):
    torch.manual_seed(0)
    fault(monkeypatch)
    res = run_toy(toy_root, mix)
    res.pop("_record")
    assert res["correct"] is False, res["check"]
