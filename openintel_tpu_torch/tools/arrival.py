"""Arrival-rate curves: per-request dispatch against the BatchCoalescer.

The port's counterpart of the reference's ``scripts/bench_arrival.py``:
requests of ``--request-b`` queries arrive at Poisson times with offered
rate lambda (requests a second), open loop. A dispatcher submits each at
its scheduled arrival to a wide thread pool; nobody waits for the previous
request, so queueing lands in the measured latency instead of throttling
the load. Two serving modes over the same retriever: ``direct`` calls
``retriever.search`` per request, ``coalesced`` routes through
``BatchCoalescer(max_batch, max_wait_ms)``. Per (mode, rate) point: the
achieved request rate, latency p50/p95/p99 (completion minus scheduled
arrival) and ``saturated`` (achieved < 95 % of offered, or the in-flight
cap tripped). The sweep's rates are ``--fractions`` of the measured direct
capacity (1 / one request's latency).

    python -m openintel_tpu_torch.tools.arrival [--request-b 64]
        [--duration S] [--fractions 0.3,0.6,0.9,1.3,2.0,3.0]
        [--max-wait-ms 2.0] [--max-batch 256] [--device cpu] [--out PATH]

Env: BENCH_DOCS (default 1,250,000 on the card, 20,000 on the CPU),
BENCH_DENSE (default int8 on the card, kernel A; xla on the CPU),
BENCH_STORE (default bf16 on the card, f32 on the CPU). Writes the curves
to ``--out`` (default ``build/tools/arrival_curves.json``) and prints the
markdown rows; the progress goes to stderr.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np

from openintel_tpu_torch.index.schema import dense_store_dtype
from openintel_tpu_torch.serving import BatchCoalescer
from openintel_tpu_torch.tools import common

K, C_ARM = 10, 32
# In-flight request cap: an open-loop run past saturation grows its queue
# without bound; once this many requests are outstanding the point is
# saturated and further arrivals only stretch the drain.
MAX_INFLIGHT = 128
N_REQUESTS_POOL = 64


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_point(submit_fn, queries_pool, *, offered_rps: float, duration_s: float, k: int,
              rng: np.random.Generator) -> dict:
    """One (mode, rate) measurement: Poisson arrivals at ``offered_rps``
    requests a second for ``duration_s``, open loop."""
    pool = ThreadPoolExecutor(max_workers=MAX_INFLIGHT)
    latencies: list[float] = []
    lat_lock = threading.Lock()
    errors: list[str] = []
    inflight = 0
    inflight_lock = threading.Lock()
    capped = False

    def serve(qs, scheduled: float) -> None:
        nonlocal inflight
        try:
            submit_fn(qs, k)
            done = time.monotonic()
            with lat_lock:
                latencies.append(done - scheduled)
        except Exception as e:  # noqa: BLE001 - surfaced in the result
            with lat_lock:
                errors.append(repr(e))
        finally:
            with inflight_lock:
                inflight -= 1

    t0 = time.monotonic()
    next_at = t0
    submitted = 0
    futures = []
    while True:
        next_at += float(rng.exponential(1.0 / offered_rps))
        if next_at - t0 > duration_s:
            break
        now = time.monotonic()
        if next_at > now:
            time.sleep(next_at - now)
        with inflight_lock:
            if inflight >= MAX_INFLIGHT:  # saturated: stop offering, drain the queue
                capped = True
                break
            inflight += 1
        futures.append(pool.submit(serve, queries_pool[submitted % len(queries_pool)], next_at))
        submitted += 1
    wait(futures, timeout=120.0)
    pool.shutdown(wait=False)
    wall = time.monotonic() - t0
    n = len(latencies)
    lats = np.sort(np.asarray(latencies)) if n else np.zeros(1)

    def pct(p: float) -> float:
        return round(float(lats[int(p * (len(lats) - 1))]) * 1e3, 1)

    return {
        "offered_rps": round(offered_rps, 2),
        "achieved_rps": round(n / wall if wall > 0 else 0.0, 2),
        "submitted": submitted,
        "completed": n,
        "p50_ms": pct(0.50),
        "p95_ms": pct(0.95),
        "p99_ms": pct(0.99),
        "saturated": bool(capped or (submitted and n < 0.95 * submitted)),
        "inflight_capped": capped,
        "errors": errors[:3],
    }


def arrival_curves(retriever, all_q, *, request_b: int, fractions, duration: float,
                   max_batch: int = 256, max_wait_ms: float = 2.0) -> dict:
    """Warm every wave size the sweep can hit, measure the two capacity
    anchors (direct: 1 / one request's latency; coalesced: a full wave),
    then sweep both modes at each fraction of the direct capacity. ``all_q``
    holds ``N_REQUESTS_POOL * request_b`` query strings."""
    b = request_b
    pool_q = [all_q[i * b : (i + 1) * b] for i in range(len(all_q) // b)]

    def direct(qs, k=K, **fkw):
        return retriever.search(qs, k=k, candidates_per_arm=C_ARM, **fkw)

    co = BatchCoalescer(direct, max_batch=max_batch, max_wait_ms=max_wait_ms)
    # coalesced waves come in multiples of b up to max_batch: each size once,
    # so no point's tail pays a first call
    for wave in range(b, max_batch + 1, b):
        direct(all_q[:wave])
    log(f"warmed {max_batch // b} wave sizes")

    best = float("inf")
    for _ in range(5):
        s = time.monotonic()
        direct(pool_q[0])
        best = min(best, time.monotonic() - s)
    direct_cap_rps = 1.0 / best
    s = time.monotonic()
    co.search(all_q[:max_batch], k=K)
    coalesced_cap_rps = (max_batch / b) / (time.monotonic() - s)
    log(
        f"capacity anchors: direct {direct_cap_rps:.1f} req/s ({direct_cap_rps * b:,.0f} QPS), "
        f"full-wave {coalesced_cap_rps:.1f} req/s ({coalesced_cap_rps * b:,.0f} QPS)"
    )
    curves: dict = {"direct": [], "coalesced": []}
    for frac in fractions:
        offered = frac * direct_cap_rps
        for mode, fn in (
            ("direct", lambda qs, kk: direct(qs, kk)),
            ("coalesced", lambda qs, kk: co.search(qs, k=kk)),
        ):
            pt = run_point(
                fn, pool_q, offered_rps=offered, duration_s=duration, k=K,
                rng=np.random.default_rng(7),
            )
            pt["fraction_of_direct_cap"] = frac
            curves[mode].append(pt)
            log(
                f"{mode:9s} f={frac:<4} offered {offered:6.1f} req/s: achieved "
                f"{pt['achieved_rps']:6.1f}, p50/p95 {pt['p50_ms']:.0f}/{pt['p95_ms']:.0f} ms"
                f"{'  SATURATED' if pt['saturated'] else ''}"
            )
    return {
        "direct_capacity_rps": round(direct_cap_rps, 2),
        "direct_capacity_qps": round(direct_cap_rps * b, 1),
        "coalesced_capacity_rps": round(coalesced_cap_rps, 2),
        "coalesced_capacity_qps": round(coalesced_cap_rps * b, 1),
        "curves": curves,
    }


def markdown_rows(curves: dict) -> list[str]:
    rows = [
        "| offered (xdirect cap) | direct achieved req/s | direct p50/p95 ms |"
        " coalesced achieved req/s | coalesced p50/p95 ms |",
        "|---|---|---|---|---|",
    ]
    for d, c in zip(curves["direct"], curves["coalesced"]):
        dsat = " (sat)" if d["saturated"] else ""
        csat = " (sat)" if c["saturated"] else ""
        rows.append(
            f"| {d['fraction_of_direct_cap']}x | {d['achieved_rps']}{dsat} | "
            f"{d['p50_ms']}/{d['p95_ms']} | {c['achieved_rps']}{csat} | "
            f"{c['p50_ms']}/{c['p95_ms']} |"
        )
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--request-b", type=int, default=64, help="queries per request")
    ap.add_argument("--duration", type=float, default=None,
                    help="seconds per sweep point (default 8 on the card, 3 on the CPU)")
    ap.add_argument("--fractions", default="0.3,0.6,0.9,1.3,2.0,3.0",
                    help="offered rate as fractions of the measured direct capacity")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=256)
    common.add_device_flags(ap, "arrival_curves")
    args = ap.parse_args(argv)
    device = common.tool_device(args.device)
    card = device.type == "cuda"
    cfg = common.served_defaults(device)
    duration = args.duration or (8.0 if card else 3.0)
    store = os.environ.get("BENCH_STORE", "bf16" if card else "f32")
    stamp = common.stamp(device)
    log(common.device_line(device))
    t0 = time.perf_counter()
    retriever, index, rng = common.bench_retriever(
        cfg["n_docs"], cfg["vocab_size"], cfg["kernel"], dense_store_dtype(store), device,
        device_batch=args.max_batch,
    )
    log(f"corpus + retriever ready ({time.perf_counter() - t0:.0f}s, {device.type}, {retriever.kernel})")
    all_q = common.bench_strings(index, rng, N_REQUESTS_POOL * args.request_b, cfg["vocab_size"])
    res = arrival_curves(
        retriever, all_q, request_b=args.request_b,
        fractions=[float(f) for f in args.fractions.split(",")], duration=duration,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
    )
    results = {
        "config": {
            "n_docs": cfg["n_docs"], "dim": common.DIM, "request_b": args.request_b,
            "max_batch": args.max_batch, "max_wait_ms": args.max_wait_ms,
            "duration_s": duration, "kernel": retriever.kernel, "store": store,
        },
        **stamp,
        **res,
    }
    log(f"wrote {common.write_json(results, args.out, 'arrival_curves')}")
    for row in markdown_rows(res["curves"]):
        print(row, flush=True)
    errors = [p["errors"] for mode in res["curves"].values() for p in mode if p["errors"]]
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
