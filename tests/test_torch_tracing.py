"""The port's span recorder (``openintel_tpu_torch.utils.profiling``) and the
spans the port records at its layer boundaries, on the CPU: parents nest
per thread, one wave's spans share its id on the producer's thread and the
consumer's, the ring stays bounded and counts its drops, a recorder that is
off records nothing, the profiler sees ``oi.`` spans only while it records,
the clock offset fitted from a profile maps the spans onto it, the C++
planner's span carries its phase totals without changing its plans, and
``server_stats`` reports the spans."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openintel_tpu_torch import native
from openintel_tpu_torch.index.synthetic import synthetic_postings_index
from openintel_tpu_torch.mcp.tools import run_server_stats
from openintel_tpu_torch.models.retrievers import HybridRetriever
from openintel_tpu_torch.serving import BatchCoalescer, PipelinedSearcher
from openintel_tpu_torch.utils import profiling
from openintel_tpu_torch.utils.profiling import Recorder, Span, fit_clock_offset, recorder, span


@pytest.fixture
def fresh(monkeypatch):
    """A recorder of the process's size in place of the process's own."""
    rec = Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def test_parents_nest_per_thread(fresh):
    barrier = threading.Barrier(2)

    def work(tag):
        with span(f"outer.{tag}", n=3):
            barrier.wait(timeout=10)
            with span(f"inner.{tag}") as inner:
                inner.attrs["tag"] = tag
                barrier.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    recs = {r.name: r for r in fresh.records()}
    assert set(recs) == {"outer.a", "inner.a", "outer.b", "inner.b"}
    for tag in "ab":
        outer, inner = recs[f"outer.{tag}"], recs[f"inner.{tag}"]
        assert outer.parent == 0 and inner.parent == outer.id
        assert inner.thread == outer.thread and inner.attrs == {"tag": tag}
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
        assert outer.n == 3 and inner.n == 1
    assert recs["outer.a"].thread != recs["outer.b"].thread
    agg = fresh.aggregates()
    assert agg["outer.a"]["calls"] == 1 and agg["outer.a"]["n"] == 3
    assert agg["outer.a"]["wall_s"] >= agg["inner.a"]["wall_s"] > 0


def test_a_wave_shares_its_id_on_the_producer_and_the_consumer(fresh):
    texts = [f"tok{i} alpha beta{i % 13} gamma{i % 5}" for i in range(300)]
    r = HybridRetriever.build(texts, dim=32, device_batch=8, device="cpu")
    waves = [[f"tok{(w * 7 + j) % 300} alpha" for j in range(5 + w)] for w in range(3)]
    got = list(PipelinedSearcher(r, depth=1).search_stream(iter(waves), k=4))
    assert len(got) == 3
    by_wave: dict = {}
    for rec in fresh.records():
        if rec.wave is not None:
            by_wave.setdefault(rec.wave, []).append(rec)
    assert len(by_wave) == 3
    for w, recs in by_wave.items():
        names = {x.name for x in recs}
        assert {"encode", "prepare", "plan", "quantize", "stage", "step", "dense_arm",
                "bm25_arm", "fuse", "copy_back", "finalize"} <= names, names
        producer = {x.thread for x in recs if x.name in ("encode", "prepare", "plan")}
        consumer = {x.thread for x in recs if x.name in ("step", "finalize")}
        assert len(producer) == 1 and len(consumer) == 1 and producer != consumer
        n = {x.name: x.n for x in recs}
        assert n["encode"] == n["prepare"] == n["finalize"] == len(waves[w - min(by_wave)])
    waits = [x for x in fresh.records() if x.name == "pipeline.wait_wave" and x.wave is not None]
    assert {x.wave for x in waits} == set(by_wave)


def test_the_ring_stays_bounded_and_reports_its_drops():
    rec = Recorder(capacity=8)
    assert rec.dropped == 0 and rec.last_drop_ns is None
    for i in range(20):
        with Span(rec, f"s{i}", i, None, {}):
            pass
    held = rec.records()
    assert [r.name for r in held] == [f"s{i}" for i in range(12, 20)]
    assert rec.dropped == 12 and rec.last_drop_ns == held[-1].end_ns
    rec.interval("late", held[-1].end_ns, held[-1].end_ns + 5, n=2, wave=7)
    assert len(rec.records()) == 8 and rec.dropped == 13
    assert rec.records()[-1][:3] == ("late", held[-1].end_ns, held[-1].end_ns + 5)
    assert rec.records(held[-1].start_ns)[0].name == "s19"
    rec.clear()
    assert rec.records() == [] and rec.dropped == 0


def test_a_recorder_that_is_off_records_nothing(fresh):
    fresh.enabled = False
    with span("quiet", n=5) as s:
        s.attrs["x"] = 1
        s.wave = 3
    fresh.interval("quiet.wait", 0, 10)
    assert fresh.records() == [] and fresh.aggregates() == {}
    fresh.enabled = True
    with span("heard"):
        pass
    assert [r.name for r in fresh.records()] == ["heard"]


def test_record_function_only_under_an_active_profiler(fresh, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened without a profiler")

    with monkeypatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        with span("plain"):
            pass

    def worker():
        with span("worker"):
            torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
    names = {name for name, _, _ in profiling.profiler_spans(prof)}
    assert "main" in names and "plain" not in names
    assert {r.name for r in fresh.records()} == {"plain", "main", "worker"}


def test_the_fitted_clock_offset_maps_every_matched_span(fresh):
    def work(tag, n):
        for i in range(n):
            with span(f"{tag}.outer", n=i):
                time.sleep(0.0002 * (1 + i % 3))
                with span(f"{tag}.inner"):
                    torch.ones(8).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work("main", 40)
    events = profiling.profiler_spans(prof)
    assert len(events) == 80
    with span("after.profile"):  # records the profiler never saw
        pass
    offset, matched = fit_clock_offset(events, fresh.records())
    # the profiler's clock is Unix time: the offset is about time_ns's
    assert abs(offset - (time.time_ns() - time.perf_counter_ns())) < 50_000_000
    starts: dict = {}
    for r in fresh.records():
        starts.setdefault(r.name, []).append(r.start_ns + offset)
    near = [min(abs(s - x) for x in starts[name]) for name, s, _ in events]
    within = sum(d <= 50_000 for d in near)
    assert within == matched >= 72, sorted(near)[-10:]
    assert fit_clock_offset(events, []) is None


def test_the_planner_span_carries_its_phases_and_the_plans_stay_as_they_were(fresh, monkeypatch):
    native.build()
    lib = native._load()
    assert lib is not None
    index = synthetic_postings_index(20_000, vocab_size=3_000, seed=5)
    rng = np.random.default_rng(6)
    term_ids = [list(rng.integers(1, 400, size=4)) for _ in range(64)]
    got = native.native_build_query_plan(index, term_ids, 16, 32, n_threads=3, bitmap_min_df=256)
    planners = [r for r in fresh.records() if r.name == "planner"]
    assert len(planners) == 1
    attrs = planners[0].attrs
    assert planners[0].n == 64 and attrs["threads"] == 3
    assert set(attrs) == {"threads", *native.PHASES, *native.COUNTS}
    assert all(attrs[p] >= 0 for p in native.PHASES) and attrs["intersect"] > 0
    assert 0 <= attrs["multi_queries"] <= 64 and attrs["multi_hits"] > 2 * 32 * attrs["multi_queries"]
    names = {r.name for r in fresh.records()}
    assert {"setup.impact_order", "setup.pruned_cache", "setup.bitmap_cache"} <= names

    class NoPhases:
        """The library with the phase array left out (a null pointer)."""

        def __getattr__(self, name):
            return getattr(lib, name)

        def plan_build_masked(self, *args):
            return lib.plan_build_masked(*args[:-1], None)

    monkeypatch.setattr(native, "_lib", NoPhases())
    want = native.native_build_query_plan(index, term_ids, 16, 32, n_threads=3, bitmap_min_df=256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # the caches are built once: no second set-up span
    assert sum(r.name == "setup.pruned_cache" for r in fresh.records()) == 1


@pytest.mark.parametrize("nan", [False, True])
def test_the_set_up_spans_say_which_route_ran(fresh, nan):
    """``setup.impact_order`` carries ``route``: ``"key"`` (the stable sort
    of one int64 key) on a plain index, ``"lexsort"`` where an impact is
    NaN; ``setup.pruned_cache`` carries ``"mask"`` either way (its doc ids
    ascend within each term)."""
    index = synthetic_postings_index(5_000, vocab_size=300, seed=7)
    if nan:
        index.impact[3] = np.nan
    index.pruned_cache(16)
    recs = {r.name: r for r in fresh.records()}
    assert recs["setup.impact_order"].attrs == {"route": "lexsort" if nan else "key"}
    assert recs["setup.impact_order"].n == index.nnz
    assert recs["setup.pruned_cache"].attrs == {"max_m": 16, "route": "mask"}


def test_server_stats_reports_the_spans(fresh):
    r = HybridRetriever.build(["a b c", "b c d", "c d e"], dim=16, device="cpu")
    co = BatchCoalescer(lambda q, k=10: r.search(q, k=k), max_batch=4, max_wait_ms=1.0)
    co.search(["b c"], k=2)
    co.search(["a b", "c d", "d e", "e a"], k=2)  # a full wave: run directly
    stats = run_server_stats(r, co)["spans"]
    assert stats["coalescer.wave"]["calls"] == 2 and stats["coalescer.wave"]["n"] == 5
    assert stats["coalescer.queue_wait"]["calls"] == 1
    assert stats["setup.corpus_copy"]["n"] == 3
    for name, s in stats.items():
        assert set(s) == {"calls", "host_s", "n", "p50_ms", "p95_ms"}, name
        assert s["calls"] >= 1 and 0 <= s["p50_ms"] <= s["p95_ms"] and s["host_s"] >= 0
    waves = {x.wave for x in recorder().records() if x.name in ("coalescer.wave", "prepare")}
    assert len(waves) == 2 and None not in waves
