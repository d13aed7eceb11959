"""Spans around the program's calls into each layer, from the benchmark's
own files (the program's source is not changed).

In the traced run, :class:`Spans` wraps each target by name for the
length of the run: the wrapper records the host clock and opens a
``torch.profiler.record_function("pb.<span>")``, so that the profiler can
give each kernel to the span that launched it. ``n`` counts the work a
call was given (queries, sub-batches, rows), where the target has such a
count.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Callable, Optional

import torch

# span name -> (module path, attribute path, work count of a call)
TARGETS: dict[str, tuple[str, str, Optional[Callable]]] = {
    "prepare": (
        "openintel_tpu_torch.models.retrievers", "HybridRetriever.prepare",
        lambda a, kw: len(a[1]),
    ),
    "run_prepared_device": (
        "openintel_tpu_torch.models.retrievers", "HybridRetriever.run_prepared_device",
        lambda a, kw: int(a[1].queries.shape[0]),
    ),
    "finalize_prepared": (
        "openintel_tpu_torch.models.retrievers", "HybridRetriever.finalize_prepared", None,
    ),
    "fuse_arms": ("openintel_tpu_torch.models.retrievers", "HybridRetriever._fuse_arms", None),
    "filtered_fallback": (
        "openintel_tpu_torch.models.retrievers", "HybridRetriever._filtered_fallback",
        lambda a, kw: len(a[2]),
    ),
    "dense_arm_topk": ("openintel_tpu_torch.models.retrievers", "dense_arm_topk", None),
    "bm25_topk_device": ("openintel_tpu_torch.models.retrievers", "bm25_topk_device", None),
    "search_embeddings": (
        "openintel_tpu_torch.models.retrievers", "DenseRetriever.search_embeddings",
        lambda a, kw: len(a[1]),
    ),
}

PREFIX = "pb."


def _resolve(module: str, path: str):
    import importlib

    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


class Spans:
    """Host-clock spans of the wrapped calls: per span name, a list of
    (start, end, n, thread) on ``time.perf_counter``."""

    def __init__(self, targets: dict = TARGETS):
        self.targets = targets
        self.records: dict[str, list] = {name: [] for name in targets}
        self._saved: list = []
        self._lock = threading.Lock()

    def _wrap(self, name: str, fn, count):
        records, lock = self.records[name], self._lock

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(PREFIX + name):
                    return fn(*args, **kwargs)
            finally:
                n = count(args, kwargs) if count is not None else 1
                with lock:
                    records.append((t0, time.perf_counter(), n, threading.get_ident()))

        return wrapper

    def install(self) -> None:
        for name, (module, path, count) in self.targets.items():
            owner, attr = _resolve(module, path)
            fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(name, fn, count))

    def uninstall(self) -> None:
        while self._saved:
            owner, attr, fn = self._saved.pop()
            setattr(owner, attr, fn)

    def summary(self, t0: float, t1: float) -> dict:
        """Per span, the calls that started in [t0, t1): their count, host
        seconds and work count; 0 calls where the span saw none."""
        out = {}
        for name, recs in self.records.items():
            sel = [r for r in recs if t0 <= r[0] < t1]
            out[name] = {
                "calls": len(sel),
                "host_s": sum(r[1] - r[0] for r in sel),
                "n": sum(r[2] for r in sel),
            }
        return out
