"""Closed loop over ``DenseRetriever.search_embeddings``: batches of query
embeddings, each batch's top-k on the host before the next is sent."""

from __future__ import annotations

import time

from portbench import roofline
from portbench.harness import program
from portbench.harness.check import Plan
from portbench.harness.data import Order
from portbench.harness.window import Tracer, Window

HYBRID = False  # BM25 and the fusion take part: the inputs hold postings


def plan(cfg: dict, traffic: dict, inputs) -> Plan:
    """The top-k of the arm alone, from the arm's default candidates."""
    k = int(traffic["k"])
    return Plan(k=k, c=k, fetch=roofline.arm_candidates(k, None), hybrid=HYBRID)


def build(cfg: dict, traffic: dict, inputs, seed: int, device):
    retr = program.dense_retriever(cfg, inputs.rows, inputs.pool, device)
    return DenseDriver(retr, inputs.pool, traffic, seed)


class DenseDriver:
    def __init__(self, retriever, pool, traffic: dict, seed: int):
        self.retriever, self.pool = retriever, pool
        self.batch = int(traffic["batch"])
        self.k = int(traffic["k"])
        self.warm_batches = int(traffic["warm_batches"])
        self.order = Order(len(pool), seed)
        self.next = 0

    def _call(self):
        idx = self.order.take(self.next, self.batch)
        self.next += self.batch
        res = self.retriever.search_embeddings(self.pool.emb[idx], self.k)
        return idx, res

    def warm(self) -> None:
        for _ in range(self.warm_batches):
            self._call()

    def close(self) -> None:
        pass

    def run(self, seconds: float, tracer: Tracer) -> Window:
        win = Window(t0=time.perf_counter(), seconds=seconds)
        tracer.arm(win.t0)
        while True:
            idx, res = self._call()
            now = time.perf_counter()
            win.queries += len(idx)
            win.answers.append((idx, res.ids, res.scores))
            tracer.poll(now)
            if now >= win.t0 + seconds:  # the window ends with a batch
                win.t1 = now
                break
        tracer.stop()
        return win
