"""A closed loop over a live corpus (``UpdatableHybridRetriever``): before
each wave of query strings, one write, acknowledged before the wave is
sent: the next ``add_batch`` docs of the write pool, in order, then
``delete_batch`` ids drawn from the seed among the docs alive so far.
Each wave names the state it was sent in. A write that raises is counted
as failed, leaves the state as it was and ends the writes of the run.

The toy cells' driver of the live mix: ``conftest.py`` adds it to a toy
root as ``drivers/live.py``, a new file."""

from __future__ import annotations

import itertools
import time

import numpy as np

from portbench.harness import program
from portbench.harness.check import Plan
from portbench.harness.data import Order, live_pool, rng
from portbench.harness.window import Tracer, Window

HYBRID = True


def plan(cfg: dict, traffic: dict, inputs) -> Plan:
    """Both arms take ``candidates_per_arm``; the fusion is the
    configuration's (RRF for the live corpus)."""
    k, c = int(traffic["k"]), int(traffic["candidates_per_arm"])
    return Plan(k=k, c=c, fetch=c, hybrid=HYBRID)


def writes(n_base: int, n_pool: int, spec: dict, seed: int):
    """The writes, one after another: (pooled docs [lo, hi) to add, ids to
    delete), from the seed; the deletes drawn among the docs alive after
    the add."""
    n_visible, dead = n_base, np.zeros(0, np.int64)
    for j in itertools.count():
        lo = n_visible - n_base
        hi = min(lo + int(spec["add_batch"]), n_pool)
        n_visible = n_base + hi
        alive = np.setdiff1d(np.arange(n_visible), dead)
        gone = rng(seed, "order", 1 << 21, j).choice(
            alive, size=min(int(spec["delete_batch"]), alive.size - 1), replace=False)
        dead = np.concatenate([dead, gone])
        yield lo, hi, gone


def control_states(cfg: dict, traffic: dict, inputs, seed: int, idx: np.ndarray):
    """For the control: the states of the first writes, ``idx`` spread over
    them in turn; (states, deletes, each query's state)."""
    states, deletes = [], []
    n_writes = 8
    for _, (_, hi, gone) in zip(range(n_writes), writes(inputs.n_base, len(inputs.rows) - inputs.n_base,
                                                        traffic["writes"], seed)):
        deletes += gone.tolist()
        states.append((inputs.n_base + hi, len(deletes)))
    return states, deletes, np.arange(len(idx)) % n_writes


def build(cfg: dict, traffic: dict, inputs, seed: int, device):
    live = live_pool(inputs.postings, inputs.rows, inputs.n_base)
    retr = program.updatable_retriever(cfg, live.base, inputs.rows[: inputs.n_base], inputs.pool, device)
    return LiveDriver(retr, inputs, live, traffic, seed)


class LiveDriver:
    def __init__(self, retriever, inputs, live, traffic: dict, seed: int):
        self.retriever, self.pool, self.live = retriever, inputs.pool, live
        self.wave, self.k = int(traffic["wave"]), int(traffic["k"])
        self.c = int(traffic["candidates_per_arm"])
        self.warm_waves = int(traffic["warm_waves"])
        self.order = Order(len(self.pool), seed)
        self.next = 0
        self.writes = writes(inputs.n_base, len(live.texts), traffic["writes"], seed)
        self.n_visible, self.deletes = inputs.n_base, []
        self.failed, self.errors = 0, []

    def close(self) -> None:
        pass

    def _write(self) -> None:
        if self.failed:
            return
        lo, hi, gone = next(self.writes)
        try:
            if hi > lo:
                self.retriever.add_documents(self.live.texts[lo:hi], self.live.rows[lo:hi])
                self.n_visible += hi - lo
            self.retriever.delete_ids(gone)
        except (ValueError, IndexError, RuntimeError) as e:  # a write that failed: counted
            self.failed += 1
            self.errors.append(repr(e))
            return
        self.deletes += gone.tolist()

    def _wave(self):
        idx = self.order.take(self.next, self.wave)
        self.next += self.wave
        res = self.retriever.search([self.pool.texts[i] for i in idx], k=self.k,
                                    candidates_per_arm=self.c, query_embeddings=self.pool.emb[idx])
        return idx, res

    def warm(self) -> None:
        """A wave at the base segment, then waves after writes: both of the
        live corpus's search paths."""
        self._wave()
        for _ in range(self.warm_waves):
            self._write()
            self._wave()

    def run(self, seconds: float, tracer: Tracer) -> Window:
        win = Window(t0=time.perf_counter(), seconds=seconds)
        tracer.arm(win.t0)
        while True:
            self._write()
            win.states.append((self.n_visible, len(self.deletes)))
            idx, res = self._wave()
            now = time.perf_counter()
            win.queries += len(idx)
            win.answers.append((idx, res.ids, res.scores, len(win.states) - 1))
            tracer.poll(now)
            if now >= win.t0 + seconds:
                win.t1 = now
                break
        tracer.stop()
        win.deletes = list(self.deletes)
        win.failed, win.errors = self.failed, self.errors
        return win
