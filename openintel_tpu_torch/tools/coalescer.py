"""The coalescer under real concurrent load.

The port's counterpart of the reference's ``scripts/bench_coalescer.py``:
N threads each loop 64-query searches through ``serving.BatchCoalescer``
over the served ``HybridRetriever``, as ``mcp/server.py`` composes them, so
concurrent callers fuse into full 256-query waves. It reports

- ``served_b64_concurrent_qps``: completed queries a second over all
  callers (what a deployment of b=64 clients gets), and
- ``raw_b64_qps``: the unfused single caller's rate, for contrast.

    python -m openintel_tpu_torch.tools.coalescer [--device cpu] [--out PATH]

Env: BENCH_DOCS (default 1,250,000 on the card, 20,000 on the CPU),
BENCH_DENSE (default int8 on the card, kernel A; xla on the CPU),
BENCH_CALLERS (default 8), BENCH_SECONDS (default 20). Rows are stored
bf16 on the card and f32 on the CPU, as the reference stores them on its
TPU and CPU. Host clock; the result of each call is read back.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from openintel_tpu_torch.serving import BatchCoalescer
from openintel_tpu_torch.tools import common

K, C_ARM, CALLER_B = 10, 32, 64


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def coalescer_run(retriever, queries, *, n_callers: int, seconds: float, reps: int = 6) -> dict:
    """The raw single caller's b=64 rate (best of ``reps``), then
    ``n_callers`` threads looping 64-query searches through a
    ``BatchCoalescer(max_batch=256, max_wait_ms=2.0)`` for ``seconds``;
    each caller's result is checked for its shape."""

    def search_fn(qs, k=K, **fkw):
        return retriever.search(qs, k=k, candidates_per_arm=C_ARM, **fkw)

    co = BatchCoalescer(search_fn, max_batch=256, max_wait_ms=2.0)
    co.search(queries[:256], k=K)  # warm both shapes: a 256 wave, a raw 64
    search_fn(queries[:CALLER_B])
    best = float("inf")
    for _ in range(reps):
        s = time.perf_counter()
        search_fn(queries[:CALLER_B])
        best = min(best, time.perf_counter() - s)
    raw_b64 = CALLER_B / best
    log(f"raw b=64 single caller: {raw_b64:,.0f} QPS")
    waves0, queries0 = co.batches_run, co.queries_run

    stop = time.perf_counter() + seconds
    done = [0] * n_callers
    errors: list = []
    span = max(len(queries) - CALLER_B, 1)

    def caller(i: int) -> None:
        lo = (i * CALLER_B * 4) % span
        while time.perf_counter() < stop:
            try:
                res = co.search(queries[lo : lo + CALLER_B], k=K)
                if res.ids.shape != (CALLER_B, K):
                    raise AssertionError(f"result shape {res.ids.shape}")
                done[i] += CALLER_B
            except Exception as e:  # noqa: BLE001 - surfaced in the result
                errors.append(repr(e))
                return
            lo = (lo + CALLER_B) % span

    s = time.perf_counter()
    threads = [threading.Thread(target=caller, args=(i,)) for i in range(n_callers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - s
    served = sum(done) / wall
    waves, fused = co.batches_run - waves0, co.queries_run - queries0
    log(
        f"{n_callers} x b={CALLER_B} callers for {wall:.1f}s: {sum(done)} queries, "
        f"{served:,.0f} QPS served; {waves} fused waves "
        f"({fused / max(waves, 1):.0f} q/wave)"
    )
    return {
        "served_b64_concurrent_qps": served,
        "raw_b64_qps": raw_b64,
        "fused_waves": waves,
        "queries_per_wave": fused / max(waves, 1),
        "n_callers": n_callers,
        "seconds": wall,
        "vs_baseline": served / 100_000.0,
        "errors": errors[:3],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    common.add_device_flags(parser, "coalescer")
    args = parser.parse_args(argv)
    device = common.tool_device(args.device)
    cfg = common.served_defaults(device)
    n_callers = int(os.environ.get("BENCH_CALLERS", 8))
    seconds = float(os.environ.get("BENCH_SECONDS", 20))
    stamp = common.stamp(device)
    log(common.device_line(device))
    t0 = time.perf_counter()
    store = torch.bfloat16 if device.type == "cuda" else np.float32
    retriever, index, rng = common.bench_retriever(
        cfg["n_docs"], cfg["vocab_size"], cfg["kernel"], store, device
    )
    log(f"corpus + retriever ready ({time.perf_counter() - t0:.0f}s, {device.type}, {retriever.kernel})")
    # bench-style queries; each caller cycles its own slice
    queries = common.bench_strings(index, rng, CALLER_B * max(n_callers, 4) * 4, cfg["vocab_size"])
    res = coalescer_run(retriever, queries, n_callers=n_callers, seconds=seconds)
    res = {
        "metric": f"coalesced_b64_qps_{cfg['n_docs'] / 1e6:.2f}M_docs", **res, **stamp,
        "kernel": retriever.kernel, "n_docs": cfg["n_docs"],
    }
    path = common.write_json(res, args.out, "coalescer")
    log(f"wrote {path}")
    print(json.dumps(res), flush=True)
    return 1 if res["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
