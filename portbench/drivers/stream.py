"""Closed loop over ``PipelinedSearcher(depth=2)``: waves of query strings
through ``search_stream``, or, where the mix has masks, through
``run_prepared_stream`` with each query's filter. A wave's queries count
once its top-k is on the host."""

from __future__ import annotations

import threading
import time

from portbench.harness import program
from portbench.harness.check import Plan
from portbench.harness.data import Order
from portbench.harness.window import Tracer, Window
from portbench.reference.dense import filtered_fetch_width

DEPTH = 2  # waves in flight: the pipelined searcher's default

HYBRID = True  # BM25 and the fusion take part: the inputs hold postings


def plan(cfg: dict, traffic: dict, inputs) -> Plan:
    """Both arms take ``candidates_per_arm``; under masks the dense arm
    fetches wide enough for the most selective mask (every sub-batch of
    the mix holds one)."""
    k, c = int(traffic["k"]), int(traffic["candidates_per_arm"])
    fetch = c
    if inputs.masks is not None:
        fetch = filtered_fetch_width(c, cfg["n_docs"], int(inputs.masks.sum(1).min()))
    return Plan(k=k, c=c, fetch=fetch, hybrid=HYBRID)


def build(cfg: dict, traffic: dict, inputs, seed: int, device):
    retr = program.hybrid_retriever(cfg, inputs.postings, inputs.rows, inputs.pool, device)
    return StreamDriver(retr, inputs, traffic, seed)


class StreamDriver:
    def __init__(self, retriever, inputs, traffic: dict, seed: int):
        self.retriever, self.pool, self.masks = retriever, inputs.pool, inputs.masks
        self.wave = int(traffic["wave"])
        self.k = int(traffic["k"])
        self.c = int(traffic["candidates_per_arm"])
        self.warm_waves = int(traffic["warm_waves"])
        self.searcher = program.pipelined(retriever, DEPTH)
        self.order = Order(len(self.pool), seed)
        self.next = 0

    def warm(self) -> None:
        """The warm-up waves run at the head of the window's own stream."""

    def close(self) -> None:
        pass

    def _waves(self, stop: threading.Event, sent: list):
        pool = self.pool
        while not stop.is_set():
            idx = self.order.take(self.next, self.wave)
            self.next += self.wave
            sent.append(idx)
            texts = [pool.texts[i] for i in idx]
            if self.masks is None:
                yield texts
            else:  # the encoding search_stream does, with the wave's filters
                yield (
                    [program.encode_query(self.retriever, t) for t in texts],
                    self.retriever.dense.embedder(texts),
                    {"filter_mask": self.masks, "filter_group": pool.groups[idx]},
                )

    def run(self, seconds: float, tracer: Tracer) -> Window:
        stop, sent = threading.Event(), []
        stream = (self.searcher.search_stream if self.masks is None
                  else self.searcher.run_prepared_stream)
        it = stream(self._waves(stop, sent), k=self.k, candidates_per_arm=self.c)
        win = None
        try:
            for n, res in enumerate(it):
                now = time.perf_counter()
                if win is None:
                    if n + 1 == self.warm_waves:  # set-up ends: the window opens
                        win = Window(t0=now, seconds=seconds)
                        tracer.arm(now)
                    continue
                win.queries += len(sent[n])
                win.answers.append((sent[n], res.ids, res.scores))
                tracer.poll(now)
                if now >= win.t0 + seconds:  # the window ends with a wave
                    win.t1 = now
                    break
        finally:
            stop.set()
            it.close()
        tracer.stop()
        return win
