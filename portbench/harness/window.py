"""What every driver shares: the window a run measures, and the tracer that
profiles a stretch of it.

A closed loop's window opens when a warm-up wave comes back and closes
when the first wave that comes back at ``seconds`` or later does, so that
it holds whole waves and all their time. An open loop's window is its
schedule; the answers due in it are waited for ``DRAIN_S`` past its end.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

DRAIN_S = 60.0  # how long answers due in the window are waited for after it


def _read(path: str) -> Optional[str]:
    try:
        return Path(path).read_text()
    except OSError:
        return None


def host_load() -> dict:
    """What the host shows of its load, where it shows it: the 1-minute
    load average, the CPU time so far (jiffies: all, idle with iowait,
    stolen by the hypervisor), the total stall of runnable tasks (CPU
    pressure, microseconds) and this process's CPU seconds. Read at the
    window's ends, so that a slow run can be told from a busy host."""
    out = {"proc_cpu_s": time.process_time(), "t": time.perf_counter()}
    text = _read("/proc/loadavg")
    if text:
        out["load1"] = float(text.split()[0])
    text = _read("/proc/stat")
    if text:
        cpu = [int(x) for x in text.split("\n", 1)[0].split()[1:]]
        out["jiffies"] = (sum(cpu[:8]), sum(cpu[3:5]), cpu[7] if len(cpu) > 7 else 0)
    text = _read("/proc/pressure/cpu")
    if text:
        out["stall_us"] = int(text.split("total=")[1].split()[0])
    return out


def host_shares(a: dict, b: dict) -> dict:
    """Between two :func:`host_load` readings, in %: the host's busy and
    stolen shares of its CPU time, the share of the time in which some
    runnable task waited for a CPU, and the CPU this process used (100 a
    core); and the load averages at both ends. What the host does not
    show is left out."""
    span = b["t"] - a["t"]
    out = {"proc_cpu_pct": 100.0 * (b["proc_cpu_s"] - a["proc_cpu_s"]) / span}
    if "load1" in a and "load1" in b:
        out["load1"] = [a["load1"], b["load1"]]
    if "jiffies" in a and "jiffies" in b and b["jiffies"][0] > a["jiffies"][0]:
        total, idle, steal = (y - x for x, y in zip(a["jiffies"], b["jiffies"]))
        out["busy_pct"] = 100.0 * (1 - idle / total)
        out["steal_pct"] = 100.0 * steal / total
    if "stall_us" in a and "stall_us" in b:
        out["cpu_stall_pct"] = 1e-4 * (b["stall_us"] - a["stall_us"]) / span
    return out


@dataclass
class Window:
    t0: float
    seconds: float
    queries: int = 0  # queries whose top-k reached the host inside the window
    requests: int = 0  # requests due inside the window (open loop)
    failed: int = 0
    latencies: list = field(default_factory=list)  # seconds per request, open loop
    # (pool indices, (n, k) ids, (n, k) scores[, state]) of the answers; the
    # state, where given, indexes ``states``: what the answer was served from
    answers: list = field(default_factory=list)
    # a live corpus's states, (n_visible, n_dead): the first n_visible docs
    # were added and the first n_dead ids of ``deletes``, the one
    # append-only log of deleted ids, deleted; each acknowledged before an
    # answer that names it was sent
    states: list = field(default_factory=list)
    deletes: list = field(default_factory=list)
    errors: list = field(default_factory=list)
    t1: float = 0.0  # the window's end
    last_done: float = 0.0  # when the last answer came back (open loop)
    host0: dict = field(default_factory=lambda: host_load())  # the host at the opening

    @property
    def attempted(self) -> int:
        return self.requests if self.requests else self.queries


class Tracer:
    """Starts the profiler ``lead`` seconds into the window and stops it
    ``length`` seconds later, polled from the traffic loop itself."""

    def __init__(self, profile_factory=None, lead: float = 0.0, length: float = 0.0):
        self.factory, self.lead, self.length = profile_factory, lead, length
        self.prof = None
        self.state = "off" if profile_factory is None else "idle"
        self.start_at = self.stop_at = math.inf

    def arm(self, t0: float) -> None:
        self.start_at, self.stop_at = t0 + self.lead, t0 + self.lead + self.length

    def poll(self, now: float) -> None:
        if self.state == "idle" and now >= self.start_at:
            self.prof = self.factory()
            self.prof.start()
            self.state = "on"
        elif self.state == "on" and now >= self.stop_at:
            self.stop()

    def stop(self) -> None:
        if self.state == "on":
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()
            self.state = "done"
