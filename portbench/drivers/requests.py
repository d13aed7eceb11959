"""Open loop over the ``search_corpus`` tool: requests of query strings at
fixed arrival times through the MCP server's coalescer, each timed from
its scheduled arrival to the caller holding its result, whether or not
earlier requests have come back."""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Optional

import numpy as np

from portbench.harness import program
from portbench.harness.check import Plan
from portbench.harness.data import Order, rng
from portbench.harness.window import DRAIN_S, Tracer, Window

HYBRID = True  # BM25 and the fusion take part: the inputs hold postings


def plan(cfg: dict, traffic: dict, inputs) -> Plan:
    """Both arms take the server's candidates for k."""
    k = int(traffic["k"])
    c = program.server_candidates(k)
    return Plan(k=k, c=c, fetch=c, hybrid=HYBRID)


def build(cfg: dict, traffic: dict, inputs, seed: int, device):
    retr = program.hybrid_retriever(cfg, inputs.postings, inputs.rows, inputs.pool, device)
    return RequestsDriver(retr, inputs.pool, traffic, seed)


def open_loop_schedule(rate: float, seconds: float, sizes: dict, seed: int):
    """Arrival times in [0, seconds) and request sizes. Every seed gets the
    same set of gaps (the quantiles of an exponential at ``rate``, a
    Poisson process's gaps) and of sizes (``single_share`` of 1, the rest
    log-uniform over ``range``), in an order drawn from the seed."""
    n = max(1, int(round(rate * seconds)))
    r = rng(seed, "order", 1 << 20)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    r.shuffle(gaps)
    arrivals = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    arrivals *= seconds / gaps.sum()
    n_one = int(round(n * sizes["single_share"]))
    lo, hi = sizes["range"]
    m = n - n_one
    u = (np.arange(m) + 0.5) / max(m, 1)
    rest = np.floor(np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))).astype(np.int64)
    size = np.concatenate([np.ones(n_one, np.int64), np.minimum(rest, hi)])
    r.shuffle(size)
    return arrivals, size


class RequestsDriver:
    def __init__(self, retriever, pool, traffic: dict, seed: int):
        self.retriever, self.pool, self.traffic, self.seed = retriever, pool, traffic, seed
        self.k = int(traffic["k"])
        co = traffic["coalescer"]
        self.coalescer = program.coalesced_search(retriever, co["max_batch"], co["max_wait_ms"])
        self.workers = int(traffic["workers"])
        self.executor = ThreadPoolExecutor(max_workers=self.workers)
        self.order = Order(len(pool), seed)
        self.next = 0

    def _take(self, n: int) -> np.ndarray:
        idx = self.order.take(self.next, int(n))
        self.next += int(n)
        return idx

    def _call(self, idx: np.ndarray):
        return program.search_corpus(
            self.retriever, self.coalescer, [self.pool.texts[i] for i in idx], self.k
        )

    def warm(self) -> None:
        """One request on this thread first (the program builds its kernels
        at first use, and concurrent first calls race on the build), then
        spawn every worker and send bursts of the cell's request sizes at
        once, so that the coalescer forms waves of every width the window
        can see."""
        self._call(self._take(self.coalescer.max_batch))
        gate = threading.Barrier(self.workers + 1)
        spawned = [self.executor.submit(gate.wait, 60) for _ in range(self.workers)]
        gate.wait(60)
        wait(spawned)
        _, sizes = open_loop_schedule(64.0, 1.0, self.traffic["sizes"], self.seed)
        for _ in range(int(self.traffic["warm_bursts"])):
            futs = [self.executor.submit(self._call, self._take(s)) for s in sizes]
            for f in futs:
                f.result()

    def close(self) -> None:
        self.executor.shutdown(wait=False, cancel_futures=True)

    def run(self, seconds: float, tracer: Tracer, rate: Optional[float] = None) -> Window:
        rate = float(rate if rate is not None else self.traffic["rate_rps"])
        arrivals, sizes = open_loop_schedule(rate, seconds, self.traffic["sizes"], self.seed + self.next)
        reqs = [self._take(s) for s in sizes]
        n = len(reqs)
        done_at = [math.nan] * n
        results: list = [None] * n
        win = Window(t0=time.perf_counter(), seconds=seconds, requests=n)
        win.t1 = win.t0 + seconds
        lock = threading.Lock()

        def serve(j: int) -> None:
            try:
                res = self._call(reqs[j])
            except Exception as e:  # noqa: BLE001 - counted as failed, shown in the result
                with lock:
                    win.errors.append(repr(e))
                return
            done_at[j] = time.perf_counter()
            results[j] = res

        tracer.arm(win.t0)
        futures = []
        for j, a in enumerate(arrivals):
            target = win.t0 + a
            while True:
                now = time.perf_counter()
                tracer.poll(now)
                if now >= target:
                    break
                time.sleep(min(target - now, 0.05))
            futures.append(self.executor.submit(serve, j))
        while time.perf_counter() < win.t0 + seconds:
            tracer.poll(time.perf_counter())
            time.sleep(0.01)
        tracer.stop()
        deadline = win.t0 + seconds + DRAIN_S
        wait(futures, timeout=max(0.0, deadline - time.perf_counter()))
        give_up = time.perf_counter()
        for j in range(n):
            sched = win.t0 + arrivals[j]
            if results[j] is None:
                win.failed += 1
                win.latencies.append(give_up - sched)  # slower than any that came back
            else:
                win.latencies.append(done_at[j] - sched)
                win.queries += len(reqs[j])
                win.answers.append((reqs[j], *results[j]))
        win.last_done = max((d for d in done_at if d == d), default=win.t0)
        return win
