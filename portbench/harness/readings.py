"""What the metric readers share: sums over the spans of the traced window
and over the profiled stretch. Each returns None where there is nothing
to read, so that a metric of a layer the run did not reach is left out."""

from __future__ import annotations

from typing import Iterable, Optional

from portbench.harness.trace import device_seconds_under


def span_sum(rec: dict, names: Iterable[str], field: str) -> Optional[float]:
    """The sum of ``field`` (calls, host_s, n) over the spans ``names`` in
    the traced window; None without spans or without a call."""
    spans = rec.get("spans")
    if not spans:
        return None
    names = list(names)
    if not any(spans.get(n, {}).get("calls") for n in names):
        return None
    return float(sum(spans[n][field] for n in names if n in spans))


def subbatches(rec: dict) -> Optional[float]:
    """Sub-batches the window's steps ran: one dense-arm call each."""
    return span_sum(rec, ["dense_arm_topk"], "calls")


def traced_subbatches(rec: dict) -> Optional[int]:
    t = rec.get("trace")
    n = t["span_calls"].get("dense_arm_topk", 0) if t else 0
    return n or None


def device_under(rec: dict, names: Iterable[str]) -> Optional[float]:
    t = rec.get("trace")
    return device_seconds_under(t, names) if t else None


def idle_pct(rec: dict) -> Optional[float]:
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or t["device_ops"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def ratio(num: Optional[float], den: Optional[float], scale: float = 1.0) -> Optional[float]:
    if num is None or not den:
        return None
    return scale * num / den
