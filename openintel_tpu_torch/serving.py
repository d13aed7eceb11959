"""Serving-side batch aggregation: the port of ``openintel_tpu.serving``.

``BatchCoalescer`` wraps any batched ``search(queries, k, ...) ->
SearchResult`` callable (``HybridRetriever.search``) with a thread-safe
request queue: concurrent callers' queries coalesce into one device batch
of up to ``max_batch`` queries, flushed when full or ``max_wait_ms`` after
the wave opened (a hard latency bound: the timer is not re-armed by
latecomers). Callers block until their slice of the fused result returns.
The dense arm streams the whole corpus per device batch, so a small batch
pays nearly a full batch's device time; coalescing is how many small
callers share it.

``PipelinedSearcher`` is the throughput layer for a stream of query waves.
It overlaps three stages: the host plan and the staging of operands (wave
i + 1, on a producer thread), the device step (wave i) and the copy of the
result back (wave i - 1), so that the rate approaches 1 / max(stage)
instead of 1 / sum(stages). On the card that needs more than a thread:

- the producer stages on a CUDA stream of its own, from pinned host
  memory, and the step waits for its event (``HybridRetriever.prepare``,
  ``run_prepared_device``), so staging never queues behind the steps;
- each wave's result is copied into pinned buffers right after its step
  (``HybridRetriever.copy_back``), and the consumer waits for that copy's
  event alone, not for the next wave's step queued behind it;
- the producer's heavy work, the C++ planner (``ctypes``) and torch's
  copies, runs without the GIL; the consumer's ~200 launches a sub-batch
  hold it. ``stage_seconds`` keeps each stage's host time per wave, so a
  run can show how much the two threads slow each other.

On the CPU there are no streams or events: each stage runs to its end in
turn, on the same two threads.

Filtered waves serve too: a wave's third element passes ``filter_mask``
and ``filter_group`` to ``prepare``, and ``finalize_prepared`` patches
its starved queries on the consumer's stream; coalesced callers' filters
fuse into one grouped batch (``fuse_filter_entries``).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from openintel_tpu_torch.models.retrievers import SearchResult
from openintel_tpu_torch.ops.bm25 import encode_query

# A per-query filter entry for coalesced serving: None (unfiltered) or
# (hashable key identifying the filter, (n_docs,) bool mask). Waves dedupe
# on the key, so two callers with the same tenant filter share one mask
# row without comparing N-sized arrays. A key must identify the mask's
# content: two entries with equal keys and different masks in one wave
# would serve the first-seen mask to both.
FilterEntry = Optional[tuple]

# Unfiltered queries in a mixed wave dedupe under this private sentinel,
# which no caller's key can equal
_UNFILTERED_KEY = object()


def fuse_filter_entries(
    entries: Sequence[FilterEntry],
) -> tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Fuse per-query filter entries into the retrievers' grouped-filter
    operands ((G, n_docs) masks, (B,) int32 groups), deduped by key, with
    one shared all-True row for the unfiltered queries of a mixed wave.
    Returns (None, None) when every entry is None (the unfiltered search
    serves)."""
    if all(e is None for e in entries):
        return None, None
    keys: dict = {}
    masks: list[np.ndarray] = []
    groups: list[int] = []
    n_docs = np.asarray(next(e for e in entries if e is not None)[1]).shape[0]
    for e in entries:
        key, mask = (_UNFILTERED_KEY, None) if e is None else e
        g = keys.get(key)
        if g is None:
            g = keys[key] = len(masks)
            masks.append(np.ones(n_docs, bool) if mask is None else np.asarray(mask))
        groups.append(g)
    return np.stack(masks), np.asarray(groups, np.int32)


def _empty_result(k: int) -> SearchResult:
    return SearchResult(ids=np.zeros((0, k), np.int32), scores=np.zeros((0, k), np.float32))


class PipelinedSearcher:
    """Double-buffered serving over a stream of query waves.

    A producer thread runs ``retriever.prepare`` into a bounded queue; the
    consumer queues wave i's step and its copy back, and only then waits
    for wave i - 1's copy, so planning and staging, the device step and
    the copy overlap. Errors from either side reach the caller; the
    producer stops at the first one, and the waves before it are still
    delivered.

    ``depth`` bounds the queue of prepared waves (each holds its staged
    operands on the device until it runs). ``stage_seconds`` holds the
    last stream's host seconds per wave: ``prepare`` (producer),
    ``dispatch`` (queueing the step and its copy) and ``finalize`` (the
    wait for the copy and the result's assembly)."""

    def __init__(self, retriever, *, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.retriever = retriever
        self.depth = depth
        self.stage_seconds: dict[str, list[float]] = {}
        self._stage_stream = None  # the producer's CUDA stream, made at first use

    def _staging(self):
        """The producer's context: on the card its own stream, so staging
        copies do not queue behind the consumer's steps."""
        dev = self.retriever.device
        if dev.type != "cuda":
            return contextlib.nullcontext()
        if self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(device=dev)
        return torch.cuda.stream(self._stage_stream)

    def run_prepared_stream(
        self,
        waves,
        *,
        k: int = 10,
        candidates_per_arm: Optional[int] = None,
        device_batch: Optional[int] = None,
    ):
        """``waves``: iterable of (term_ids, query_embeddings) pairs (and
        an optional third element, a dict of extra ``prepare`` kwargs such
        as ``filter_mask``). Yields one SearchResult per wave, in order."""
        retr = self.retriever
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        end, err = object(), object()
        times = self.stage_seconds = {"prepare": [], "dispatch": [], "finalize": []}

        def put(item) -> bool:
            # a plain put could block forever once the consumer has gone:
            # bounded waits re-check `stop`
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with self._staging():
                    for wave in waves:
                        if stop.is_set():
                            return
                        term_ids, emb, *rest = wave
                        kwargs = rest[0] if rest else {}
                        t0 = time.perf_counter()
                        prep = retr.prepare(
                            term_ids, emb, k=k, candidates_per_arm=candidates_per_arm,
                            device_batch=device_batch, **kwargs,
                        )
                        times["prepare"].append(time.perf_counter() - t0)
                        if not put(prep):
                            return
                put(end)
            except BaseException as e:  # noqa: BLE001 - delivered below
                put((err, e))

        def finalize(pending) -> SearchResult:
            t0 = time.perf_counter()
            res = retr.finalize_prepared(*pending)
            times["finalize"].append(time.perf_counter() - t0)
            return res

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        pending = None  # (prep, its HostCopy in flight)
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, tuple) and item[0] is err:
                    # the waves before the failure are delivered; it
                    # surfaces at its own position in the stream
                    if pending is not None:
                        yield finalize(pending)
                        pending = None
                    raise item[1]
                prep = item
                if prep.n_queries == 0:
                    out = None
                else:
                    # queue wave i's step and copy before waiting on wave i - 1's
                    t0 = time.perf_counter()
                    out = retr.copy_back(retr.run_prepared_device(prep))
                    times["dispatch"].append(time.perf_counter() - t0)
                if pending is not None:
                    yield finalize(pending)
                pending = (prep, out) if out is not None else None
                if out is None:
                    yield _empty_result(prep.k)
            if pending is not None:
                yield finalize(pending)
        finally:
            stop.set()
            # release staged waves so that their device buffers free
            # promptly; the producer's puts watch `stop`, so it exits, and
            # a put that won the race with the first drain is drained after
            # the join
            self._drain(q)
            t.join(timeout=30)
            self._drain(q)

    @staticmethod
    def _drain(q: queue.Queue) -> None:
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                return

    def search_stream(
        self, query_waves, *, k: int = 10, candidates_per_arm: Optional[int] = None
    ):
        """``query_waves`` yields lists of query strings; the encoding
        (tokenise and embed) runs on the producer side too."""
        retr = self.retriever

        def encoded():
            for queries in query_waves:
                term_ids = [encode_query(retr.bm25.index, t) for t in queries]
                yield term_ids, retr.dense.embedder(list(queries))

        return self.run_prepared_stream(encoded(), k=k, candidates_per_arm=candidates_per_arm)


class _Pending:
    __slots__ = ("queries", "k", "filters", "event", "result", "error")

    def __init__(
        self, queries: Sequence[str], k: int, filters: Optional[Sequence[FilterEntry]] = None
    ):
        self.queries = list(queries)
        self.k = k
        self.filters: list[FilterEntry] = (
            list(filters) if filters is not None else [None] * len(self.queries)
        )
        self.event = threading.Event()
        self.result: SearchResult | None = None
        self.error: BaseException | None = None


class BatchCoalescer:
    """Coalesce concurrent search calls into full device batches.

    ``search_fn(queries, k=...) -> SearchResult`` takes a list of query
    strings. Requests with different ``k`` coalesce too: the fused call
    runs at the wave's largest k and each caller's rows are trimmed. Waves
    flush when ``max_batch`` queries are queued or ``max_wait_ms`` after
    the wave opened, whichever comes first."""

    def __init__(
        self,
        search_fn: Callable[..., SearchResult],
        *,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._search = search_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._lock = threading.Lock()
        self._queue: list[_Pending] = []
        self._queued = 0  # queries queued now
        self._flusher: threading.Thread | None = None
        self.batches_run = 0  # fused search calls
        self.queries_run = 0
        # in-flight search calls by wave id -> start time: a call that hangs
        # in native code shows in oldest_inflight_s() for a health check
        self._inflight: dict[int, float] = {}

    def search(
        self,
        queries: Sequence[str],
        k: int = 10,
        filters: Optional[Sequence[FilterEntry]] = None,
    ) -> SearchResult:
        """Blocking, thread-safe: this caller's ranked results.

        ``filters`` (one :data:`FilterEntry` per query) lets filtered
        searches coalesce too: the wave fuses every caller's entries into
        one grouped-filter batch (``fuse_filter_entries``) for a
        ``search_fn`` that takes ``filter_mask``/``filter_group``."""
        if not queries:
            return _empty_result(k)
        if filters is not None and len(filters) != len(queries):
            raise ValueError("filters must align with queries")
        if len(queries) >= self.max_batch:
            # already a full wave: run it directly, no queueing latency
            token = object()
            with self._lock:
                self.batches_run += 1
                self.queries_run += len(queries)
                self._inflight[id(token)] = time.monotonic()
            try:
                return self._search(list(queries), k=k, **self._filter_kwargs(filters))
            finally:
                with self._lock:
                    self._inflight.pop(id(token), None)
        req = _Pending(queries, k, filters)
        with self._lock:
            self._queue.append(req)
            self._queued += len(req.queries)
            full = self._queued >= self.max_batch
            if full:
                wave = self._take_wave_locked()
            elif self._flusher is None:
                self._flusher = threading.Thread(target=self._flush_after_wait, daemon=True)
                self._flusher.start()
        if full:
            self._run_wave(wave)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result  # type: ignore[return-value]

    def _take_wave_locked(self) -> list[_Pending]:
        """Pop queued requests up to ``max_batch`` queries, never more (the
        batch the serving config provisioned). Requests are never split;
        a queued request is below max_batch by construction. A remainder
        stays queued for the armed flusher."""
        wave: list[_Pending] = []
        n = 0
        while self._queue:
            nxt = len(self._queue[0].queries)
            if wave and n + nxt > self.max_batch:
                break
            wave.append(self._queue.pop(0))
            n += nxt
        self._queued -= n
        if not self._queue:
            self._flusher = None  # nothing left: cancel any armed flusher
        return wave

    def _flush_after_wait(self) -> None:
        time.sleep(self.max_wait)
        while True:
            with self._lock:
                if threading.current_thread() is not self._flusher:
                    return  # a full wave already flushed and replaced us
                wave = self._take_wave_locked()
                more = bool(self._queue)
                if not more:
                    self._flusher = None
            if wave:
                self._run_wave(wave)
            if not more:
                return

    def oldest_inflight_s(self) -> float | None:
        """Seconds the longest-running in-flight search call has been out,
        or None when idle. A value far above a batch's usual latency means
        the call hung."""
        with self._lock:
            if not self._inflight:
                return None
            return time.monotonic() - min(self._inflight.values())

    @staticmethod
    def _filter_kwargs(filters: Optional[Sequence[FilterEntry]]) -> dict:
        """Grouped-filter kwargs for ``search_fn``; {} when the wave is
        entirely unfiltered (the unfiltered search keeps serving)."""
        if filters is None:
            return {}
        masks, groups = fuse_filter_entries(filters)
        if masks is None:
            return {}
        return {"filter_mask": masks, "filter_group": groups}

    def _run_wave(self, wave: list[_Pending]) -> None:
        all_q = [q for r in wave for q in r.queries]
        k_max = max(r.k for r in wave)
        with self._lock:
            self.batches_run += 1
            self.queries_run += len(all_q)
            self._inflight[id(wave)] = time.monotonic()
        try:
            res = self._search(
                all_q, k=k_max, **self._filter_kwargs([f for r in wave for f in r.filters])
            )
        except BaseException as e:  # noqa: BLE001 - delivered to each caller
            for r in wave:
                r.error = e
                r.event.set()
            return
        finally:  # runs on the except-return path too
            with self._lock:
                self._inflight.pop(id(wave), None)
        lo = 0
        for r in wave:
            hi = lo + len(r.queries)
            r.result = SearchResult(
                ids=np.asarray(res.ids[lo:hi, : r.k]),
                scores=np.asarray(res.scores[lo:hi, : r.k]),
            )
            lo = hi
            r.event.set()
