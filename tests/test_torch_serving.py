"""The port's serving layer (``openintel_tpu_torch.serving``) on the CPU.

Every test of ``tests/test_serving.py`` has its counterpart here: the
coalescer tests with the same plain Python search functions, the pipeline
tests on a port ``HybridRetriever(device="cpu")``. Beside them: the
pipelined stream against the JAX package's own (``PipelinedSearcher`` over
the JAX ``HybridRetriever``, Pallas in interpret mode on the CPU, as in
``tests/test_torch_retriever.py``) on the same seeded corpus and waves,
under that file's near-tie rule (``ranking_utils.assert_ranking_close``:
scores within 1e-5, ids equal outside clusters of scores within 1e-5);
filtered waves and coalesced filtered requests, equal to the sequential
path and to direct filtered searches; and the drain race of the
pipeline's shutdown."""

import itertools
import queue
import threading
import time

import numpy as np
import pytest
from ranking_utils import assert_ranking_close

from openintel_tpu import serving as jserving
from openintel_tpu.index.schema import DenseIndex
from openintel_tpu.index.synthetic import (
    synthetic_embeddings,
    synthetic_postings_index,
    synthetic_query_embeddings,
)
from openintel_tpu.models import retrievers as jr
from openintel_tpu_torch import convert, serving
from openintel_tpu_torch.models.retrievers import HostCopy, HybridRetriever, SearchResult
from openintel_tpu_torch.ops.bm25 import encode_query
from openintel_tpu_torch.serving import BatchCoalescer, PipelinedSearcher, fuse_filter_entries

TOL = 1e-5


def echo_search(queries, k=10):
    """Deterministic fake: row i's top hit encodes the query's own number."""
    ids = np.zeros((len(queries), k), np.int32) - 1
    scores = np.zeros((len(queries), k), np.float32)
    for i, q in enumerate(queries):
        ids[i, 0] = int(q.split("-")[1])
        scores[i, 0] = 1.0
    return SearchResult(ids=ids, scores=scores)


def _zeros(n, k):
    return SearchResult(ids=np.zeros((n, k), np.int32), scores=np.zeros((n, k), np.float32))


# ---------------------------------------------------------------------------
# BatchCoalescer
# ---------------------------------------------------------------------------


def test_concurrent_waves_fuse_and_route_correctly():
    co = BatchCoalescer(echo_search, max_batch=64, max_wait_ms=50.0)
    results, errors = {}, []

    def worker(base):
        try:
            results[base] = co.search([f"q-{base + j}" for j in range(8)], k=4)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(b * 100,)) for b in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and len(results) == 8
    for base, res in results.items():
        assert res.ids.shape == (8, 4)
        np.testing.assert_array_equal(res.ids[:, 0], [base + j for j in range(8)])
    # 8 callers x 8 queries = 64 = max_batch: ideally one fused call
    assert co.batches_run <= 3, co.batches_run
    assert co.queries_run == 64


def test_quiet_queue_flushes_after_wait():
    co = BatchCoalescer(echo_search, max_batch=1000, max_wait_ms=10.0)
    res = co.search(["q-7"], k=2)  # alone: must not hang
    assert res.ids[0, 0] == 7
    assert co.batches_run == 1


def test_full_batch_bypasses_queue():
    co = BatchCoalescer(echo_search, max_batch=4, max_wait_ms=1000.0)
    res = co.search([f"q-{i}" for i in range(4)], k=3)
    np.testing.assert_array_equal(res.ids[:, 0], [0, 1, 2, 3])
    assert co.batches_run == 1  # direct, no wait window


def test_mixed_k_trims_per_caller():
    co = BatchCoalescer(echo_search, max_batch=8, max_wait_ms=20.0)
    out = {}

    def w(name, k):
        out[name] = co.search([f"q-{k}"], k=k)

    ts = [threading.Thread(target=w, args=(f"r{k}", k)) for k in (2, 5)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert out["r2"].ids.shape == (1, 2) and out["r5"].ids.shape == (1, 5)
    assert out["r2"].ids[0, 0] == 2 and out["r5"].ids[0, 0] == 5


def test_search_fn_error_propagates_to_every_caller():
    def boom(queries, k=10):
        raise RuntimeError("device fell over")

    co = BatchCoalescer(boom, max_batch=8, max_wait_ms=5.0)
    with pytest.raises(RuntimeError, match="device fell over"):
        co.search(["q-1"], k=2)


def test_empty_request_short_circuits():
    calls = []

    def spy(queries, k=10):
        calls.append(queries)
        return echo_search(queries, k)

    co = BatchCoalescer(spy, max_batch=8)
    assert co.search([], k=5).ids.shape == (0, 5)
    assert calls == []


def test_end_to_end_with_real_retriever():
    docs = [
        "the quick brown fox",
        "lazy dogs sleep all day",
        "market analysis of tech stocks",
        "foxes and dogs living together",
    ]
    r = HybridRetriever.build(docs, dim=32, device="cpu")
    co = BatchCoalescer(
        lambda qs, k: r.search(qs, k=k, candidates_per_arm=2 * k), max_batch=4, max_wait_ms=10.0
    )
    assert co.search(["quick fox"], k=2).ids[0, 0] == 0


def test_fused_waves_never_exceed_max_batch():
    """Two concurrent 200-query callers at max_batch=256 fuse into waves of
    at most 256 queries."""
    sizes = []

    def fake_search(queries, k=10):
        sizes.append(len(queries))
        return _zeros(len(queries), k)

    co = BatchCoalescer(fake_search, max_batch=256, max_wait_ms=30.0)
    results = [None, None]

    def call(i):
        results[i] = co.search([f"q{i}-{j}" for j in range(200)], k=5)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r is not None and r.ids.shape == (200, 5) for r in results)
    assert sum(sizes) == 400 and max(sizes) <= 256, sizes


def test_oldest_inflight_tracks_hung_device_calls():
    release = threading.Event()

    def slow_search(queries, k=10):
        release.wait(timeout=10)
        return _zeros(len(queries), k)

    co = BatchCoalescer(slow_search, max_batch=4, max_wait_ms=1.0)
    assert co.oldest_inflight_s() is None
    t = threading.Thread(target=lambda: co.search(["a", "b", "c", "d"], k=3), daemon=True)
    t.start()
    deadline = time.time() + 5
    while co.oldest_inflight_s() is None and time.time() < deadline:
        time.sleep(0.01)
    stuck = co.oldest_inflight_s()
    assert stuck is not None and stuck >= 0
    time.sleep(0.05)
    assert co.oldest_inflight_s() > stuck  # grows while hung
    release.set()
    t.join(timeout=5)
    assert co.oldest_inflight_s() is None  # cleared on completion


def test_fuse_filter_entries():
    m1 = np.array([True, False, True])
    m2 = np.array([False, True, True])
    assert fuse_filter_entries([None, None]) == (None, None)
    masks, groups = fuse_filter_entries([("a", m1), None, ("b", m2), ("a", m1)])
    assert masks.shape == (3, 3) and groups.tolist() == [0, 1, 2, 0]
    np.testing.assert_array_equal(masks[0], m1)
    assert masks[1].all()  # shared all-True row for unfiltered queries
    np.testing.assert_array_equal(masks[2], m2)


def test_filtered_requests_coalesce():
    """Concurrent callers with different filters fuse into one grouped
    batch; each caller's rows come back from its own group."""
    calls = []

    def search_fn(queries, k=10, filter_mask=None, filter_group=None):
        calls.append((list(queries), filter_mask, filter_group))
        n = len(queries)
        g = filter_group if filter_group is not None else np.zeros(n, np.int32)
        ids = np.tile(np.arange(k, dtype=np.int32), (n, 1))
        ids[:, 0] = g
        return SearchResult(ids=ids, scores=np.zeros((n, k), np.float32))

    co = BatchCoalescer(search_fn, max_batch=4, max_wait_ms=50.0)
    mask_a, mask_b = np.zeros(6, bool), np.ones(6, bool)
    results = {}

    def call(name, filters):
        results[name] = co.search(["q_" + name], k=3, filters=filters)

    threads = [
        threading.Thread(target=call, args=("a", [(("a",), mask_a)])),
        threading.Thread(target=call, args=("b", [(("b",), mask_b)])),
        threading.Thread(target=call, args=("plain", None)),
        threading.Thread(target=call, args=("a2", [(("a",), mask_a)])),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert co.batches_run == 1 and co.queries_run == 4  # one fused wave
    queries, masks, groups = calls[0]
    assert masks.shape[0] == 3  # a, b, unfiltered: deduped by key
    by_q = dict(zip(queries, groups.tolist()))
    assert by_q["q_a"] == by_q["q_a2"] != by_q["q_b"]
    for name in ("a", "b", "plain"):
        assert results[name].ids[0, 0] == by_q[f"q_{name}"]


def test_unfiltered_wave_stays_on_plain_program():
    seen = []

    def search_fn(queries, k=10, **kw):
        seen.append(kw)
        return _zeros(len(queries), k)

    co = BatchCoalescer(search_fn, max_batch=2, max_wait_ms=5.0)
    co.search(["a", "b"], k=3, filters=[None, None])
    assert seen == [{}]
    with pytest.raises(ValueError, match="align"):
        co.search(["a", "b"], k=3, filters=[None])


def test_filtered_request_on_the_port_retriever_raises_for_every_caller():
    """A coalesced wave of a filtered and an unfiltered caller on the
    port's retriever runs as one grouped filtered search (two mask rows,
    one of them all-True); each caller gets its own result, equal to a
    direct search of its query with its own filter (none for the
    unfiltered caller) under the near-tie rule, and no masked id. Malformed filters still raise,
    to every caller of the wave."""
    r = HybridRetriever.build(["a b", "b c", "c d"], dim=8, device="cpu")
    mask = np.array([True, False, True])
    results, errors = {}, {}

    def run(co, entries):
        def call(name, filters):
            try:
                results[name] = co.search([name], k=2, filters=filters)
            except ValueError as e:
                errors[name] = e

        threads = [threading.Thread(target=call, args=e) for e in entries]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)

    co = BatchCoalescer(r.search, max_batch=2, max_wait_ms=50.0)
    run(co, [("b", [(("t",), mask)]), ("c", None)])
    assert co.batches_run == 1 and not errors
    want_b = r.search(["b"], k=2, filter_mask=mask)
    want_c = r.search(["c"], k=2)
    for got, want in ((results["b"], want_b), (results["c"], want_c)):
        # a product over a batch of two may round apart from one of one
        assert_ranking_close(got.scores, got.ids, want.scores, want.ids, rtol=0, atol=TOL)
    assert not (results["b"].ids == 1).any()
    co = BatchCoalescer(r.search, max_batch=2, max_wait_ms=50.0)
    run(co, [("b", [(("bad",), np.ones(4, bool))]), ("c", None)])
    assert set(errors) == {"b", "c"} and "shape" in str(errors["b"])


# ---------------------------------------------------------------------------
# PipelinedSearcher
# ---------------------------------------------------------------------------


def _pipeline_fixture(n_docs=300, dim=64):
    texts = [f"tok{i} alpha beta{i % 13} gamma{i % 5}" for i in range(n_docs)]
    r = HybridRetriever.build(texts, dim=dim, device_batch=8, device="cpu")
    waves = []
    for w in range(4):
        queries = [f"tok{(w * 7 + j) % n_docs} alpha" for j in range(5 + w)]
        term_ids = [encode_query(r.bm25.index, t) for t in queries]
        waves.append((term_ids, r.dense.embedder(queries)))
    return r, waves


def test_pipelined_stream_matches_sequential():
    """Every wave's pipelined result is bit-identical to the sequential
    prepare -> run_prepared path, in order; the stage times count each
    wave once."""
    r, waves = _pipeline_fixture()
    pipe = PipelinedSearcher(r, depth=2)
    got = list(pipe.run_prepared_stream(iter(waves), k=5))
    assert len(got) == len(waves)
    for (term_ids, emb), res in zip(waves, got):
        want = r.run_prepared(r.prepare(term_ids, emb, k=5))
        np.testing.assert_array_equal(res.ids, want.ids)
        np.testing.assert_array_equal(res.scores, want.scores)
    assert {k: len(v) for k, v in pipe.stage_seconds.items()} == {
        "prepare": 4, "dispatch": 4, "finalize": 4,
    }


def test_pipelined_search_stream_strings():
    r, _ = _pipeline_fixture(n_docs=100)
    out = list(
        PipelinedSearcher(r).search_stream(iter([["tok3 alpha"], ["tok7 alpha", "beta2"]]), k=4)
    )
    assert [o.ids.shape for o in out] == [(1, 4), (2, 4)]
    assert 3 in out[0].ids[0] and 7 in out[1].ids[0]


def test_pipelined_stream_handles_empty_wave():
    r, waves = _pipeline_fixture(n_docs=100)
    stream = [waves[0], ([], np.zeros((0, 64), np.float32)), waves[1]]
    got = list(PipelinedSearcher(r).run_prepared_stream(iter(stream), k=5))
    assert [g.ids.shape[0] for g in got] == [len(waves[0][0]), 0, len(waves[1][0])]
    want = r.run_prepared(r.prepare(*waves[1], k=5))
    np.testing.assert_array_equal(got[2].ids, want.ids)


def test_pipelined_stream_producer_error_propagates():
    r, waves = _pipeline_fixture(n_docs=100)

    def bad_waves():
        yield waves[0]
        raise RuntimeError("ingest exploded")

    it = PipelinedSearcher(r).run_prepared_stream(bad_waves(), k=5)
    assert next(it).ids.shape[0] == len(waves[0][0])
    with pytest.raises(RuntimeError, match="ingest exploded"):
        list(it)


def test_filtered_wave_raises_at_its_position():
    """A filtered wave in the pipelined stream (a single mask, then
    per-query groups with a starved include-list) is served at its
    position, equal to the sequential prepare -> run_prepared path with
    the same filter, between unfiltered waves."""
    r, waves = _pipeline_fixture()
    mask = np.zeros(r.n_docs, bool)
    mask[::2] = True
    few = np.zeros(r.n_docs, bool)
    few[[3, 50, 111]] = True
    groups = np.arange(len(waves[3][0]), dtype=np.int32) % 2
    filters = [
        {}, {}, {"filter_mask": mask},
        {"filter_mask": np.stack([mask, few]), "filter_group": groups},
    ]
    stream = [(*w, f) for w, f in zip(waves, filters)]
    got = list(PipelinedSearcher(r, depth=2).run_prepared_stream(iter(stream), k=5))
    assert len(got) == len(waves)
    for (term_ids, emb, f), res in zip(stream, got):
        want = r.run_prepared(r.prepare(term_ids, emb, k=5, **f))
        np.testing.assert_array_equal(res.ids, want.ids)
        np.testing.assert_array_equal(res.scores, want.scores)
    assert mask[got[2].ids[got[2].ids >= 0]].all()
    assert np.isin(got[3].ids[1::2][got[3].ids[1::2] >= 0], [3, 50, 111]).all()


def test_cpu_stages_have_no_events():
    """On the CPU the path is the sequential one: no staging event, and
    ``copy_back`` hands the tensors over with nothing to wait for."""
    r, waves = _pipeline_fixture(n_docs=100)
    prep = r.prepare(*waves[0], k=5)
    assert prep.ready is None
    copy = r.copy_back(r.run_prepared_device(prep))
    assert isinstance(copy, HostCopy) and copy.done is None
    res = r.finalize_prepared(prep, copy)
    np.testing.assert_array_equal(res.ids, r.run_prepared(prep).ids)


class _RacyQueue(queue.Queue):
    """A queue whose first drain that finds it empty waits (up to 1 s) for
    a put to land: the producer's put that was blocked on the full queue
    wins the race with the drain every time, as it may by chance."""

    made: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.empty_drains = 0
        _RacyQueue.made.append(self)

    def get_nowait(self):
        try:
            return super().get_nowait()
        except queue.Empty:
            self.empty_drains += 1
            if self.empty_drains == 1:
                deadline = time.monotonic() + 1.0
                while self.empty() and time.monotonic() < deadline:
                    time.sleep(0.005)
            raise


def test_drain_race_leaves_no_staged_wave_behind(monkeypatch):
    """The consumer abandons the stream with the queue full and the
    producer blocked on its next put. When the generator closes, the
    queue is empty, also when that put lands after the first drain (it is
    drained again after the join), and the producer thread has exited."""
    r, waves = _pipeline_fixture(n_docs=100)
    producers = []
    prepare = r.prepare

    def spy(*args, **kwargs):
        producers.append(threading.current_thread())
        return prepare(*args, **kwargs)

    monkeypatch.setattr(r, "prepare", spy)
    monkeypatch.setattr(serving.queue, "Queue", _RacyQueue)
    it = PipelinedSearcher(r, depth=1).run_prepared_stream(itertools.cycle(waves), k=5)
    next(it)
    q = _RacyQueue.made[-1]
    deadline = time.monotonic() + 5
    while not q.full() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert q.full()
    time.sleep(0.05)  # the producer has prepared the next wave and waits to put it
    it.close()
    assert q.empty_drains >= 1 and q.qsize() == 0
    assert not producers[0].is_alive()


# ---------------------------------------------------------------------------
# The pipelined stream against the JAX package's
# ---------------------------------------------------------------------------

N, DIM = 20_000, 64  # two int8 supers, the last one short


@pytest.fixture(scope="module")
def parity_corpus():
    index = synthetic_postings_index(N, vocab_size=2_000, seed=13)
    emb = synthetic_embeddings(N, dim=DIM, seed=14)
    rng = np.random.default_rng(15)
    q, _ = synthetic_query_embeddings(emb, 40, seed=16)
    waves = []
    for size in (16, 7, 17):  # one sub-batch, a short one, two with padding
        ranks = np.exp(rng.uniform(np.log(20), np.log(1_999), size=(size, 3)))
        term_ids = [list(r + 1) for r in ranks.astype(np.int64)]
        lo = sum(len(w[0]) for w in waves)
        waves.append((term_ids, q[lo : lo + size]))
    return index, emb, waves


@pytest.mark.parametrize("kernel", ["int8", "xla"])
def test_pipelined_stream_matches_jax(parity_corpus, kernel):
    import ml_dtypes

    index, emb, waves = parity_corpus
    dense = DenseIndex.from_embeddings(emb, dtype=ml_dtypes.bfloat16)
    j = jr.HybridRetriever(index, dense, kernel=kernel, device_batch=16)
    t = HybridRetriever(
        convert.postings_index(index), convert.dense_index_from(dense),
        kernel=kernel, device_batch=16, device="cpu",
    )
    want = list(jserving.PipelinedSearcher(j, depth=2).run_prepared_stream(
        iter(waves), k=10, candidates_per_arm=32
    ))
    got = list(PipelinedSearcher(t, depth=2).run_prepared_stream(
        iter(waves), k=10, candidates_per_arm=32
    ))
    assert len(got) == len(want) == len(waves)
    for g, w, (term_ids, _) in zip(got, want, waves):
        assert g.ids.shape == (len(term_ids), 10) and g.ids.dtype == np.int32
        np.testing.assert_allclose(g.scores, w.scores, rtol=0, atol=TOL)
        assert_ranking_close(g.scores, g.ids, w.scores, w.ids, rtol=0, atol=TOL)
