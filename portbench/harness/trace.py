"""The profiler's record of a steady stretch of the traced window, reduced to
what the per-layer readers need.

A device operation (kernel, copy, memset) belongs to every ``pb.`` span
that was open, on the launching thread, when it was launched: the
profiler links each device event to the host event that launched it (by
correlation id), and the spans nest in time on that thread. Device time
is the union of the operations' intervals, so overlapping operations
count once. The record is kept in memory; nothing is written to disk.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Iterable, Optional

from portbench.harness.spans import PREFIX

def union_seconds(intervals: Iterable[tuple[int, int]]) -> float:
    """Length of the union of [start, end) intervals in ns, in seconds."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def merged(intervals: Iterable[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class SpanIndex:
    """The ``pb.`` spans of each host thread, for "which spans were open on
    this thread at this time"."""

    def __init__(self, spans: list[tuple[int, int, int, str]]):  # (tid, start, end, name)
        by_tid: dict[int, list] = defaultdict(list)
        for tid, s, e, name in spans:
            by_tid[tid].append((s, e, name))
        self._starts, self._spans, self._longest = {}, {}, {}
        for tid, lst in by_tid.items():
            lst.sort()
            self._spans[tid] = lst
            self._starts[tid] = [s for s, _, _ in lst]
            self._longest[tid] = max(e - s for s, e, _ in lst)

    def open_at(self, tid: int, ts: int) -> set[str]:
        lst = self._spans.get(tid)
        if not lst:
            return set()
        out = set()
        j = bisect.bisect_right(self._starts[tid], ts) - 1
        floor = ts - self._longest[tid]
        while j >= 0 and lst[j][0] >= floor:
            if lst[j][1] >= ts:
                out.add(lst[j][2])
            j -= 1
        return out

    def open_anywhere(self, ts: int) -> set[str]:
        out: set[str] = set()
        for tid in self._spans:
            out |= self.open_at(tid, ts)
        return out


def reduce_events(
    host: list[tuple[int, int, int, int, str, str]],  # (correlation, tid, start, end, name, kind)
    device: list[tuple[int, int, int, int, str, str]],  # (correlation, linked, start, end, name, kind)
    window: tuple[int, int],  # the traced stretch, ns on the profiler's clock
) -> dict:
    """Device busy time, kernels and device time per span over ``window``."""
    w0, w1 = window
    spans = [(tid, s, e, name[len(PREFIX):]) for _, tid, s, e, name, _ in host if name.startswith(PREFIX)]
    index = SpanIndex(spans)
    # a device event carries the correlation id of the runtime call that
    # launched it and links to the framework op open at the launch; the
    # runtime's calls may name their thread otherwise than the framework
    # does, so their thread ids are mapped through the events that have both
    runtime, op = {}, {}
    for corr, tid, s, _, name, kind in host:
        if corr:
            launch_api = "runtime" in kind or "driver" in kind or (not kind and name.startswith("cu"))
            (runtime if launch_api else op).setdefault(corr, (tid, s))
    pairs: dict[int, defaultdict] = defaultdict(lambda: defaultdict(int))
    for corr, linked, *_ in device:
        if corr in runtime and linked in op:
            pairs[runtime[corr][0]][op[linked][0]] += 1
    thread = {t: max(c, key=c.get) for t, c in pairs.items()}
    ops, per_span, unattributed = [], defaultdict(list), 0
    kernels, by_name = 0, defaultdict(float)
    for corr, linked, s, e, name, kind in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        ops.append((s, e))
        if kind == "kernel":
            kernels += 1
        by_name[name[:120]] += (e - s) / 1e9
        names = set()
        if corr in runtime:  # the launch call itself: the innermost place
            tid, ts = runtime[corr]
            names = index.open_at(thread.get(tid, tid), ts)
        if not names and linked in op:
            names = index.open_at(*op[linked])
        if not names:
            unattributed += 1
        for n in names:
            per_span[n].append((s, e))
    busy = merged(ops)
    gaps = defaultdict(float)
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            label = "+".join(sorted(index.open_anywhere((s + prev) // 2))) or "no span"
            gaps[label] += (s - prev) / 1e9
        prev = max(prev, e)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernels": kernels,
        "device_ops": len(ops),
        "unattributed": unattributed,
        "span_calls": {n: sum(1 for *_, m in spans if m == n) for n in {m for *_, m in spans}},
        "device_s": {n: union_seconds(iv) for n, iv in per_span.items()},
        "_intervals": per_span,
        "top_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
    }


def device_seconds_under(record: dict, names: Iterable[str]) -> Optional[float]:
    """Union of the device time under any of the spans ``names``; None when
    none of them launched anything in the stretch."""
    iv = [x for n in names for x in record["_intervals"].get(n, [])]
    return union_seconds(iv) if iv else None


def _kind(event) -> str:
    at = getattr(event, "activity_type", None)
    return str(at()).lower() if callable(at) else ""


def _device_kind(event, kind: str) -> Optional[str]:
    """kernel, gpu_memcpy or gpu_memset; None for the device-side copies of
    host annotations, which are ranges and not work."""
    name = event.name()
    if name.startswith(PREFIX) or "annotation" in kind or event.is_user_annotation():
        return None
    if "memcpy" in kind or name.startswith("Memcpy"):
        return "gpu_memcpy"
    if "memset" in kind or name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def from_profiler(prof, window: Optional[tuple[int, int]] = None) -> dict:
    """Reduce a finished ``torch.profiler.profile``; ``window`` defaults to
    the span of its events."""
    host, device = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        if "CUDA" in str(ev.device_type()):
            dk = _device_kind(ev, kind)
            if dk is not None:
                device.append(
                    (ev.correlation_id(), ev.linked_correlation_id(), ev.start_ns(),
                     ev.start_ns() + ev.duration_ns(), ev.name(), dk)
                )
            continue
        host.append(
            (ev.correlation_id(), ev.start_thread_id(), ev.start_ns(),
             ev.start_ns() + ev.duration_ns(), ev.name(), kind)
        )
    if window is None:
        stamps = [h[2] for h in host] + [d[2] for d in device]
        ends = [h[3] for h in host] + [d[3] for d in device]
        window = (min(stamps), max(ends)) if stamps else (0, 0)
    out = reduce_events(host, device, window)
    out["host_events"] = len(host)
    return out
