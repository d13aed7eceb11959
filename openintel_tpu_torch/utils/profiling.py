"""Profiling and tracing: the port of :mod:`openintel_tpu.utils.profiling`.

The reference ships no tracing at all — its diagnostics are stderr warnings
plus a machine-readable ``notes`` channel threaded through reports
(reference: src/domain/engine/speculation_engine.rs:45,
src/application/analyze.rs:23-45; SURVEY.md §5). The rebuild keeps the notes
channel (see domain/engine.py) and adds what a device framework needs:

- :func:`span` — a named region of host work at a layer boundary, kept by
  the process-wide in-memory :func:`recorder` (always on, bounded, no file,
  no configuration): its start and end on ``time.perf_counter_ns``, its
  thread, its parent span, the work it was given (``n``: queries, sub-batches, rows), the wave it
  belongs to and any attributes. While a ``torch.profiler`` records, each
  span also opens ``record_function("oi.<name>")``, so the span sits in
  the profiler's host timeline beside the kernels it launched, and
  :func:`fit_clock_offset` maps the recorder's clock onto the profiler's;
- :func:`profile_trace` — capture a ``torch.profiler`` trace (the host and,
  where a card is present, its kernels) around a code block, written as a
  Chrome trace (Perfetto / TensorBoard readable) into a directory.

The spans the port records, by layer (``n`` in brackets):

- encode: ``encode`` (queries), ``PipelinedSearcher.search_stream``'s
  tokenise-and-embed of a wave;
- planner: ``prepare`` (queries) with children ``plan`` (queries),
  ``quantize`` and ``stage``; ``planner`` (queries), the C++ planner's
  call, a child of ``plan``, with attributes ``threads`` and the phase
  totals in ns summed over its worker threads (``dedup_prune``,
  ``intersect``, ``multi_select``, ``emit``, ``merge``);
- pipeline: ``pipeline.wait_wave`` (the consumer blocked on the queue of
  prepared waves), ``pipeline.wait_slot`` (the producer blocked on a full
  queue);
- step: ``step`` (sub-batches) with per sub-batch ``dense_arm``,
  ``bm25_arm`` and ``fuse`` (the host's enqueue time); ``copy_back``;
  ``finalize`` (queries) with children ``wait_device`` (the host waiting
  for the result's copy) and ``fallback`` (starved rows; attribute
  ``groups``, the distinct mask rows scanned);
- dense: ``dense.search`` (queries) with children ``dense.upload``
  (queries), ``dense_arm`` and ``wait_device``;
- set-up: ``setup.impact_order`` (postings; attribute ``route``: ``key``,
  the stable sort of one int64 key, or ``lexsort``), ``setup.pruned_cache``
  (postings; attributes ``max_m`` and ``route``: ``mask``, a compaction of
  the selection, or ``lexsort``), ``setup.bitmap_cache``,
  ``setup.corpus_copy`` and ``setup.kernels`` (attribute ``build_s``, the
  seconds ``nvcc`` took, 0.0 when cached);
- serving: ``coalescer.queue_wait`` (queries; per request, from its
  enqueue to its wave's start) and ``coalescer.wave`` (queries).

A wave's spans share its ``wave`` id, on the producer's thread and the
consumer's: ``PipelinedSearcher`` draws one per wave and carries it on the
``PreparedBatch``; a span without one takes its parent's.
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time
from typing import Iterable, Iterator, NamedTuple, Optional

import numpy as np

PREFIX = "oi."  # the spans' names in a profiler's timeline
CAPACITY = 1 << 18  # records the recorder holds; the oldest go first


class Record(NamedTuple):
    """One finished span, its times in ns on ``time.perf_counter_ns``.

    It holds no CPU time: a thread's CPU clock (``time.thread_time_ns``)
    may tick in 10 ms steps and cost a system call a read (3.5 µs on an
    H100 host, and enough while the C++ planner's threads ran to slow the
    pipelined step 2.5-fold there); a wait is a span of its own instead
    (``pipeline.wait_wave``, ``wait_device``)."""

    name: str
    start_ns: int
    end_ns: int
    thread: int  # the OS thread id
    id: int
    parent: int  # the enclosing span's id on the same thread, 0 at the top
    n: int
    wave: Optional[int]
    attrs: Optional[dict]


class Span:
    """An open span (what :func:`span` yields): ``n``, ``wave`` and
    ``attrs`` may be set before it closes."""

    __slots__ = ("name", "n", "wave", "attrs", "id", "parent", "_rec", "_local", "_rf", "_t0")

    def __init__(self, rec: "Recorder", name: str, n: int, wave: Optional[int], attrs: dict):
        self._rec, self.name, self.n, self.wave, self.attrs = rec, name, n, wave, attrs

    def __enter__(self) -> "Span":
        local = self._local = self._rec._thread()
        stack = local.stack
        if stack:
            up = stack[-1]
            self.parent = up.id
            if self.wave is None:
                self.wave = up.wave
        else:
            self.parent = 0
        self.id = next(self._rec._ids)
        stack.append(self)
        self._rf = None
        if _profiling():
            from torch.profiler import record_function

            self._rf = record_function(PREFIX + self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        local = self._local
        if local.stack and local.stack[-1] is self:
            local.stack.pop()
        self._rec._add((
            self.name, self._t0, t1, local.tid, self.id, self.parent, self.n, self.wave,
            self.attrs or None,
        ))
        return False


class _Off:
    """What :func:`span` yields while the recorder is off: attributes set
    on it go nowhere."""

    n = wave = None

    @property
    def attrs(self) -> dict:
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setattr__(self, name, value) -> None:
        pass


_OFF = _Off()


def _profiling() -> bool:
    """True while a ``torch.profiler`` records. The flag is the process's:
    a profiler that records every thread leaves
    ``torch.autograd._profiler_enabled()`` false on all of them. No
    profiler runs before ``torch`` is imported."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


class Recorder:
    """The spans of the process, in memory: a ring of at most ``capacity``
    records that drops the oldest first and counts what it dropped, with
    the time of the last drop. ``enabled = False`` stops recording; a span
    then costs one check."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.enabled = True
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._waves = itertools.count(1)
        self.clear()

    def clear(self) -> None:
        with self._lock:
            self._buf: list = [None] * self.capacity
            self._written = 0
            self.dropped = 0
            self.last_drop_ns: Optional[int] = None  # when a record last went

    def _thread(self):
        """This thread's open spans (``stack``) and OS id (``tid``)."""
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.tid = [], threading.get_native_id()
        return local

    def _add(self, rec: tuple) -> None:
        """Hold ``rec``, a :class:`Record`'s fields."""
        with self._lock:
            i = self._written
            self._written = i + 1
            if i >= self.capacity:
                self.dropped += 1
                self.last_drop_ns = rec[2]
            self._buf[i % self.capacity] = rec

    def interval(
        self, name: str, start_ns: int, end_ns: int, *, n: int = 1, wave: Optional[int] = None
    ) -> None:
        """Record a span whose ends were read apart, maybe on two threads
        (a request's wait in a queue): no parent."""
        if self.enabled:
            self._add((name, start_ns, end_ns, self._thread().tid, next(self._ids), 0, n, wave, None))

    def new_wave(self) -> int:
        """A fresh wave id."""
        return next(self._waves)

    def records(self, t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> list[Record]:
        """The held records that started in ``[t0_ns, t1_ns)`` (either end
        open when None), in the order they ended."""
        with self._lock:
            n, cap = self._written, self.capacity
            held = self._buf[:n] if n <= cap else self._buf[n % cap:] + self._buf[:n % cap]
        lo = -1 if t0_ns is None else t0_ns
        return [Record._make(r) for r in held if r[1] >= lo and (t1_ns is None or r[1] < t1_ns)]

    def aggregates(self, t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> dict:
        """Per span name over :meth:`records`: ``calls``, ``wall_s`` and ``n``
        (the work the calls were given)."""
        out: dict[str, dict] = {}
        for r in self.records(t0_ns, t1_ns):
            a = out.get(r.name)
            if a is None:
                a = out[r.name] = {"calls": 0, "wall_s": 0.0, "n": 0}
            a["calls"] += 1
            a["wall_s"] += (r.end_ns - r.start_ns) / 1e9
            a["n"] += r.n
        return out


_RECORDER = Recorder()


def recorder() -> Recorder:
    """The process-wide recorder."""
    return _RECORDER


def span(name: str, *, n: int = 1, wave: Optional[int] = None, **attrs):
    """A span of host work named ``name`` for the process-wide recorder
    (``with span("plan", n=len(queries)) as s: ...; s.attrs[...] = ...``).
    ``wave`` defaults to the enclosing span's."""
    if not _RECORDER.enabled:
        return _OFF
    return Span(_RECORDER, name, n, wave, attrs)


def profiler_spans(prof) -> list[tuple[str, int, int]]:
    """The spans a finished ``torch.profiler.profile`` saw, as (name without
    the ``oi.`` prefix, start, end) in ns on the profiler's clock."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith(PREFIX) and "CPU" in str(ev.device_type()):
            out.append((name[len(PREFIX):], ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return out


def fit_clock_offset(
    events: Iterable[tuple[str, int, int]], records: Iterable[Record], *, tolerance_ns: int = 50_000
) -> Optional[tuple[int, int]]:
    """The offset from the recorder's clock to a profiler's, fitted from
    the spans both saw: ``profiler_ns ≈ record.start_ns + offset``.

    ``events`` are the profiler's spans (:func:`profiler_spans`). The two
    clocks tick alike but start apart (the profiler's is Unix time), so a
    span lasts about as long on both. Each of the first two events of each
    name, paired with each record of that name whose duration and the next
    two's are about those of the event and the next two events, proposes
    an offset; the proposal that puts the most events within
    ``tolerance_ns`` of a record of their name wins. Every event then takes
    the record of its name nearest to it, and the offset is the median of
    the start differences of the pairs within ``tolerance_ns``, the matched
    spans. Returns (offset, matched spans), or None when no span matches."""
    ev_by: dict[str, list] = {}
    for name, s, e in events:
        ev_by.setdefault(name, []).append((s, e))
    rec_by: dict[str, list] = {}
    for r in records:
        if r.name in ev_by:
            rec_by.setdefault(r.name, []).append((r.start_ns, r.end_ns))
    names = [nm for nm in ev_by if nm in rec_by]
    if not names:
        return None
    ev = {nm: np.array(sorted(ev_by[nm]), np.int64) for nm in names}
    rec = {nm: np.array(sorted(rec_by[nm]), np.int64) for nm in names}

    def residuals(nm: str, offsets: np.ndarray, every: int = 1) -> np.ndarray:
        """(offsets, events): each ``every``-th event of ``nm`` shifted by
        each offset, less the start of the record of its name nearest it."""
        e = ev[nm][None, ::every, 0] - offsets[:, None]
        r = rec[nm][:, 0]
        j = np.clip(np.searchsorted(r, e), 1, max(len(r) - 1, 1))
        left, right = e - r[j - 1], e - r[np.minimum(j, len(r) - 1)]
        return np.where(np.abs(left) <= np.abs(right), left, right)

    # proposals: an event of a name and a record of that name whose next
    # two records last about as long as the event's next two
    cands = []
    for nm in names:
        rdur = rec[nm][:, 1] - rec[nm][:, 0]
        edur = ev[nm][:, 1] - ev[nm][:, 0]
        for i in range(min(2, len(edur))):
            close = np.ones(len(rdur), bool)
            for k in range(min(3, len(edur) - i)):
                tol = max(tolerance_ns, edur[i + k] // 20)
                close[: len(rdur) - k] &= np.abs(rdur[k:] - edur[i + k]) <= tol
                close[len(rdur) - k:] = False
            cands.append(ev[nm][i, 0] - rec[nm][close, 0])
    cands = np.unique(np.concatenate(cands))
    hits = np.zeros(len(cands), np.int64)
    for nm in names:  # scored on up to ~200 events of each name
        every = max(1, len(ev[nm]) // 200)
        for lo in range(0, len(cands), 256):
            res = residuals(nm, cands[lo:lo + 256], every)
            hits[lo:lo + 256] += (np.abs(res) <= tolerance_ns).sum(1)
    if not len(cands) or hits.max() == 0:
        return None
    best = int(cands[np.argmax(hits)])
    for _ in range(2):  # the median of the matched pairs, then the pairs it matches
        res = np.concatenate([residuals(nm, np.array([best]))[0] for nm in names])
        ok = np.abs(res) <= tolerance_ns
        best += int(np.median(res[ok]))
    res = np.concatenate([residuals(nm, np.array([best]))[0] for nm in names])
    return best, int((np.abs(res) <= tolerance_ns).sum())


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed block into
    ``log_dir`` (a ``*.pt.trace.json`` Chrome trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
